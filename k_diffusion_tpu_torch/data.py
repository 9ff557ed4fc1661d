"""Datasets and the input pipeline (counterpart of k_diffusion_tpu/data.py,
without Pillow): datasets yielding HWC float32 numpy images in [0, 1], and
a threaded prefetching loader that stacks them into numpy batches. The
Karras augmentation runs on the batch on the device
(``augmentation.py``), so the loader only decodes and resizes.

Dataset types: imagefolder and imagefolder-class (PNG files, read by
``utils.image.from_png``), mnist and cifar10 (their raw files, read with
numpy), custom (a module loaded from the config's directory) and synthetic
(Gaussian blobs, the JAX package's numpy code and so its images). Other
image formats raise ``ValueError``: JPEG, WebP and the rest wait for a
decoder, and nothing is skipped silently. ``huggingface`` raises
``NotImplementedError``: it needs the ``datasets`` package and a download.
"""

import gzip
import importlib.util
import pickle
import struct
import threading
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .utils.image import from_png, to_rgb

# the extensions the JAX package's folders read; only PNG is decoded here
IMG_EXTENSIONS = {".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
                  ".tiff", ".webp"}


def _check_format(path):
    if path.suffix.lower() != ".png":
        raise ValueError(
            f"{path}: {path.suffix.lower()[1:].upper()} images wait for a "
            "decoder in the port (ROADMAP queue 1, item 7); it reads PNG "
            "only")
    return path


def resize_center_crop(pixels, size):
    """uint8 (h, w, c) -> float32 (size, size, c) in [0, 1]: the short side
    resized to ``size`` with antialiased bicubic interpolation (a = -0.5,
    Pillow's BICUBIC filter), then the center crop, as the JAX package's
    ``_resize_center_crop`` does through Pillow. The interpolation runs on
    the uint8 pixels: torch's uint8 path, as Pillow does, rounds the
    horizontal pass to uint8 before the vertical one (a float pass differs
    from Pillow by up to 13 levels on noise). An image already at its size
    is not resampled."""
    h, w = pixels.shape[:2]
    if (h, w) != (size, size):
        scale = size / min(w, h)
        new_w, new_h = max(size, round(w * scale)), max(size, round(h * scale))
        x = torch.from_numpy(np.array(pixels)).permute(2, 0, 1)
        x = F.interpolate(x[None], size=(new_h, new_w), mode="bicubic",
                          align_corners=False, antialias=True)
        pixels = x[0].permute(1, 2, 0).numpy()
        left, top = (new_w - size) // 2, (new_h - size) // 2
        pixels = pixels[top:top + size, left:left + size]
    return pixels.astype(np.float32) / 255.0


def load_image(path, size):
    """A PNG file as an RGB float32 (size, size, 3) image in [0, 1]."""
    return resize_center_crop(to_rgb(from_png(_check_format(path))), size)


def _image_paths(root):
    return [_check_format(p) for p in sorted(Path(root).rglob("*"))
            if p.suffix.lower() in IMG_EXTENSIONS]


class FolderOfImages:
    """Every image under a directory, recursively; no classes."""

    def __init__(self, root, size):
        self.root = Path(root)
        self.size = size
        self.paths = _image_paths(self.root)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        return {"image": load_image(self.paths[i], self.size)}


class ImageFolderWithClasses:
    """torchvision's ImageFolder: a class per subdirectory, in sorted
    order."""

    def __init__(self, root, size):
        self.root = Path(root)
        self.size = size
        classes = sorted(p.name for p in self.root.iterdir() if p.is_dir())
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = [(p, self.class_to_idx[c]) for c in classes
                        for p in _image_paths(self.root / c)]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        path, cls = self.samples[i]
        return {"image": load_image(path, self.size), "class": cls}


class MNISTDataset:
    """The raw IDX files (train-images-idx3-ubyte[.gz] and the labels)."""

    def __init__(self, location, size=28, train=True):
        base = Path(location)
        prefix = "train" if train else "t10k"
        for sub in ("", "MNIST/raw", "raw"):
            d = base / sub if sub else base
            if (d / f"{prefix}-images-idx3-ubyte").exists() or \
                    (d / f"{prefix}-images-idx3-ubyte.gz").exists():
                base = d
                break
        self.images = self._read_idx(base / f"{prefix}-images-idx3-ubyte")
        self.labels = self._read_idx(base / f"{prefix}-labels-idx1-ubyte")
        self.size = size

    @staticmethod
    def _read_idx(path):
        if not path.exists():
            path = path.with_suffix(path.suffix + ".gz")
        opener = gzip.open if path.suffix == ".gz" else open
        with opener(path, "rb") as f:
            _, _, ndim = struct.unpack(">HBB", f.read(4))
            dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
            data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.reshape(dims)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        image = resize_center_crop(self.images[i][..., None], self.size)
        return {"image": image, "class": int(self.labels[i])}


class CIFAR10Dataset:
    """The pickled python batches (cifar-10-batches-py)."""

    def __init__(self, location, size=32, train=True):
        base = Path(location)
        if (base / "cifar-10-batches-py").exists():
            base = base / "cifar-10-batches-py"
        files = ([f"data_batch_{i}" for i in range(1, 6)] if train
                 else ["test_batch"])
        xs, ys = [], []
        for name in files:
            with open(base / name, "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(d[b"data"])
            ys.extend(d[b"labels"])
        self.images = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(
            0, 2, 3, 1)
        self.labels = np.asarray(ys)
        self.size = size

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return {"image": resize_center_crop(self.images[i], self.size),
                "class": int(self.labels[i])}


class SyntheticDataset:
    """Gaussian blob images with classes, for tests and measurements with
    no files on disk: the JAX package's numpy code, so the same images."""

    def __init__(self, size=32, channels=3, num_classes=0, length=10000,
                 seed=0):
        self.size = size
        self.channels = channels
        self.num_classes = num_classes
        self.length = length
        self.seed = seed

    def __len__(self):
        return self.length

    def __getitem__(self, i):
        rng = np.random.RandomState((self.seed * 1_000_003 + i) % (2 ** 31))
        cls = rng.randint(self.num_classes) if self.num_classes else 0
        yy, xx = np.mgrid[0:self.size, 0:self.size] / self.size - 0.5
        cx, cy = rng.uniform(-0.25, 0.25, 2)
        r = 0.1 + 0.2 * (cls + 1) / max(1, self.num_classes or 1)
        blob = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / r ** 2)
        img = np.repeat(blob[..., None], self.channels, axis=2).astype(
            np.float32)
        out = {"image": np.clip(img, 0, 1)}
        if self.num_classes:
            out["class"] = cls
        return out


def make_dataset(dataset_config, size, config_dir=None):
    """The dataset of a config's ``dataset`` section, as the JAX package's
    ``make_dataset``."""
    kind = dataset_config["type"]
    location = dataset_config.get("location", "data")
    if kind == "imagefolder":
        return FolderOfImages(location, size)
    if kind == "imagefolder-class":
        return ImageFolderWithClasses(location, size)
    if kind == "mnist":
        return MNISTDataset(location, size)
    if kind == "cifar10":
        return CIFAR10Dataset(location, size)
    if kind == "huggingface":
        raise NotImplementedError(
            "dataset type 'huggingface' needs the datasets package and a "
            "download; the port does not load it yet (ROADMAP queue 1, "
            "item 7)")
    if kind == "synthetic":
        return SyntheticDataset(
            size=size, channels=dataset_config.get("channels", 3),
            num_classes=dataset_config.get("num_classes", 0),
            length=dataset_config.get("length", 10000))
    if kind == "custom":
        location = (Path(config_dir or ".") / location).resolve()
        spec = importlib.util.spec_from_file_location("custom_dataset",
                                                      location)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        get_dataset = getattr(module, dataset_config.get("get_dataset",
                                                         "get_dataset"))
        return get_dataset(dataset_config.get("config", {}), size=size)
    raise ValueError("Invalid dataset type")


class DataLoader:
    """Shuffling, drop-last, prefetching batch loader yielding dicts of
    stacked numpy arrays ({"image": (B, H, W, C) float32, "class": (B,)
    int32}), as the JAX package's: epoch ``e`` visits
    ``RandomState(seed + e).permutation(len(dataset))`` in batches. With
    ``process_count`` above 1, every process shuffles with the same seed
    and takes the stride ``order[process_index::process_count]``, trimmed
    to ``len(dataset) // process_count`` items, so the processes' strides
    partition each epoch (the JAX loader's, and DistributedSampler's).

    ``epoch`` is the next epoch to iterate (each ``__iter__`` takes it and
    adds one); ``start_batch`` makes the next ``__iter__`` skip that many
    batches (index arithmetic only, nothing is read) and then returns to 0,
    so that a resumed run reads exactly the batches the interrupted run
    would have. ``num_workers`` threads assemble batches at most
    ``prefetch + num_workers`` ahead of the consumer."""

    def __init__(self, dataset, batch_size, seed=0, num_workers=4,
                 prefetch=4, drop_last=True, process_index=0,
                 process_count=1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0
        self.start_batch = 0

    def __len__(self):
        n, rem = divmod(len(self.dataset) // self.process_count,
                        self.batch_size)
        return n + int(not self.drop_last and rem > 0)

    def batch_indices(self, epoch):
        """The dataset indices of each of this process's batches of
        ``epoch``."""
        order = np.random.RandomState(self.seed + epoch).permutation(
            len(self.dataset))
        if self.process_count > 1:
            order = order[self.process_index::self.process_count][
                :len(self.dataset) // self.process_count]
        return [order[i * self.batch_size:(i + 1) * self.batch_size]
                for i in range(len(self))]

    def _assemble(self, idxs):
        items = [self.dataset[int(i)] for i in idxs]
        batch = {"image": np.stack([it["image"] for it in items])}
        if "class" in items[0]:
            batch["class"] = np.asarray([it["class"] for it in items],
                                        np.int32)
        return batch

    def __iter__(self):
        batch_idxs = self.batch_indices(self.epoch)
        self.epoch += 1
        n_batches = len(batch_idxs)
        start = min(self.start_batch, n_batches)
        self.start_batch = 0
        todo = iter(range(start, n_batches))
        lock = threading.Lock()
        cv = threading.Condition()
        results = {}
        # bounds how far the workers run ahead; released as batches go out
        sem = threading.Semaphore(self.prefetch + self.num_workers)
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                sem.acquire()
                with lock:
                    j = next(todo, None)
                if j is None or stop.is_set():
                    sem.release()
                    return
                try:
                    batch = self._assemble(batch_idxs[j])
                except Exception as e:  # raised by the consumer instead
                    batch = e
                with cv:
                    results[j] = batch
                    cv.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for j in range(start, n_batches):
                with cv:
                    while j not in results:
                        cv.wait()
                    batch = results.pop(j)
                sem.release()
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
            for _ in threads:
                sem.release()

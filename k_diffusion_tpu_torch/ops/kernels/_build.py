"""Builds the hand-written CUDA kernels and loads them with ctypes.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for sm_90a into its own
shared library with a plain C interface, at first use, into
``k_diffusion_tpu_torch/build/``. The library's file name carries a hash of
its sources and flags, so an edit rebuilds it. Nothing is prebuilt and
nothing is downloaded; a build takes seconds per file.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("fused_qkv", "na2d", "na2d_heads", "global_packed", "geglu",
           "flash")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the shared memory one block may take on the H100 (227 KB)
SMEM_PER_BLOCK = 232_448
# one (64, 64) bf16 tile of shared memory, and the slack the kernels take
# to align their tiles to 1024 bytes
TILE_BYTES, SMEM_SLACK = 8192, 1024

_libs = {}
_lock = threading.Lock()


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(path)


def library_path(name):
    """Where the library for ``csrc/<name>.cu`` is built; the name carries
    a hash of the source, the shared headers and the flags."""
    digest = hashlib.sha256()
    for part in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(part.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libkdt_{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES):
    """Compiles every library in ``names`` that is not built yet, in
    parallel. Returns the seconds taken. Raises with the compiler's output
    if a build fails. The compiler's report (registers, spills) is kept
    beside each library as ``.log``."""
    start = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [(n, library_path(n)) for n in names if not library_path(n).exists()]
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode:
            failed.append(f"--- {name}.cu ---\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - start


def load(name, **signatures):
    """The loaded library for ``csrc/<name>.cu``, built at first use.
    ``signatures`` maps each C entry point to its argument types; every
    entry point returns an int status."""
    with _lock:
        if name not in _libs:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.kdt_error_string.argtypes = [ctypes.c_int]
            lib.kdt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        lib = _libs[name]
        for fn_name, argtypes in signatures.items():
            fn = getattr(lib, fn_name)
            if fn.argtypes is None:
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        return lib


def check_launch(lib, status, what):
    """Raises if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(
            f"{what}: CUDA error {status} "
            f"({lib.kdt_error_string(status).decode()})")


def stream_ptr(device):
    """The current CUDA stream of ``device`` as a pointer for ctypes."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device):
    """The number of SMs of CUDA ``device``."""
    import torch
    index = device.index
    return _sm_count(torch.cuda.current_device() if index is None else index)


def fits(tiles):
    """Whether ``tiles`` (64, 64) bf16 tiles and the alignment slack fit in
    one block's shared memory."""
    return tiles * TILE_BYTES + SMEM_SLACK <= SMEM_PER_BLOCK


def best_split(blocks, most, slots, work):
    """How to split each of ``blocks`` blocks into g parts (1 to
    ``most``): returns (cost, g) for the g with the fewest rounds x
    ``work(g)``, the steps a block takes, where a round is ``slots(g)``
    blocks resident at once (none: g is skipped); the smaller g on a tie."""
    best = None
    for g in range(1, most + 1):
        if slots(g) < 1:
            continue
        cost = -(-blocks * g // slots(g)) * work(g)
        if best is None or cost < best[0]:
            best = (cost, g)
    if best is None:
        raise ValueError("no split of the grid fits on the device")
    return best


def grid_splits(blocks, most, device):
    """Into how many parts (1 to ``most``) to split each of ``blocks``
    blocks so that the grid holds about two blocks for each SM of
    ``device``."""
    return max(1, min(most, -(-2 * sm_count(device) // blocks)))


def row_chunk(rows, tiles, device):
    """Rows per split-K chunk of a weight gradient over ``rows`` rows whose
    output takes ``tiles`` blocks: a multiple of 64, and as many chunks as
    ``grid_splits`` gives."""
    row_tiles = -(-rows // 64)
    return 64 * -(-row_tiles // grid_splits(tiles, row_tiles, device))


def _require_kind(t, what, device, dtype, shape):
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def require(t, what, device, dtype, shape):
    """Checks that a kernel operand lies on ``device`` with the given dtype
    and shape, contiguous and 16-byte aligned (the kernels load 16-byte
    vectors); raises ValueError naming the operand otherwise."""
    _require_kind(t, what, device, dtype, shape)
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{what} must be contiguous and 16-byte aligned")


def require_rows(t, what, device, dtype, shape):
    """Checks a (rows, n) operand that the kernel reads row by row through
    its row stride: like ``require`` but the rows may lie apart, as in a
    column block of a wider matrix (a condcache row's layer scale), with
    unit inner stride and every row start 16-byte aligned. Returns the row
    stride in elements."""
    _require_kind(t, what, device, dtype, shape)
    rows, n = shape
    stride = t.stride(0) if rows > 1 else n
    if (t.stride(1) != 1 and n > 1) or stride < n or t.data_ptr() % 16 \
            or stride * t.element_size() % 16:
        raise ValueError(f"{what} must have unit inner stride and 16-byte "
                         f"aligned rows; got strides {t.stride()}")
    return stride


def require_cuda(x, what):
    """Raises unless ``x`` is a CUDA tensor: a wrapper takes its plain
    version only for CPU tensors."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")

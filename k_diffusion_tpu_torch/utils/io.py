"""The safetensors file format, read and written without the safetensors
package (counterpart of k_diffusion_tpu/utils/io.py's
``get_safetensors_metadata``; the JAX package reads and writes through
``safetensors.numpy``).

A file is an 8-byte little-endian header length, a JSON header naming each
tensor's dtype, shape and byte range (``data_offsets``, from the end of the
header) and holding the string ``__metadata__``, then the tensors' raw
little-endian bytes. The header is padded with spaces to a multiple of 8
bytes, as the safetensors package writes it.
"""

import json
import struct
from pathlib import Path

import torch

_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}
_NAMES = {dtype: name for name, dtype in _DTYPES.items()}


def _read_header(f):
    (length,) = struct.unpack("<Q", f.read(8))
    return json.loads(f.read(length))


def get_safetensors_metadata(path):
    """The ``__metadata__`` dict of a safetensors file ({} when it has
    none), reading only its header."""
    with open(path, "rb") as f:
        return _read_header(f).get("__metadata__", {})


def load_file(path):
    """Returns ({name: tensor on the CPU}, metadata) from a safetensors
    file; each tensor keeps the file's dtype (F32, F16 or BF16)."""
    with open(path, "rb") as f:
        header = _read_header(f)
        data = f.read()
    metadata = header.pop("__metadata__", {})
    tensors = {}
    for name, info in header.items():
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info['dtype']}; this reader takes "
                             f"{', '.join(_DTYPES)}")
        dtype = _DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        if end - begin != (torch.Size(info["shape"]).numel()
                           * dtype.itemsize):
            raise ValueError(f"{path}: tensor {name!r} has {end - begin} "
                             f"bytes for shape {info['shape']}")
        flat = (torch.frombuffer(bytearray(data[begin:end]), dtype=dtype)
                if end > begin else torch.empty(0, dtype=dtype))
        tensors[name] = flat.reshape(info["shape"])
    return tensors, metadata


def save_file(tensors, path, metadata=None):
    """Writes ``tensors`` ({name: tensor}, float32, float16 or bfloat16,
    on any device) and ``metadata`` ({str: str}) as a safetensors file."""
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach()
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r} has dtype {t.dtype}; this "
                             f"writer takes {', '.join(map(str, _NAMES))}")
        blob = t.to("cpu").contiguous().reshape(-1).view(torch.uint8)
        blob = blob.numpy().tobytes()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for blob in blobs:
            f.write(blob)
    return Path(path)

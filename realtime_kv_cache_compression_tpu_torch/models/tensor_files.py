"""Reader and writer of the safetensors file format, in plain Python.

The format: an 8-byte little-endian header length, a JSON header mapping
each tensor's name to its dtype, shape and `data_offsets` (counted from the
end of the header) plus an optional `__metadata__` map of strings, then the
raw little-endian bytes. HF checkpoints ship in it, and the port's
framework checkpoints (models/checkpoint.py) use it too. The port reads and
writes it with this module alone (no `safetensors` package): tensors are
read lazily, one at a time, each straight into a tensor's own host memory,
so a checkpoint never sits twice in host memory.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Iterable, Optional

import torch

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I8": torch.int8, "U8": torch.uint8, "I32": torch.int32,
          "I64": torch.int64}
_CODES = {v: k for k, v in DTYPES.items()}
INDEX_NAME = "model.safetensors.index.json"


class TensorFile:
    """One safetensors file: its header, read once, and its tensors, read
    on demand."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        self.metadata: Dict[str, str] = header.pop("__metadata__", None) or {}
        self._data_start = 8 + n
        for name, info in header.items():
            if info["dtype"] not in DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has dtype "
                                 f"{info['dtype']}; readable: "
                                 f"{sorted(DTYPES)}")
        self._entries = header

    def keys(self) -> Iterable[str]:
        return self._entries.keys()

    def get(self, name: str) -> torch.Tensor:
        """Tensor `name` on the host, its bytes read into its own memory."""
        e = self._entries[name]
        dtype, shape = DTYPES[e["dtype"]], tuple(e["shape"])
        begin, end = e["data_offsets"]
        numel = 1
        for d in shape:
            numel *= d
        if end - begin != numel * dtype.itemsize:
            raise ValueError(f"{self.path}: tensor {name!r} spans "
                             f"{end - begin} bytes, not {numel} x "
                             f"{dtype.itemsize}")
        raw = torch.empty(end - begin, dtype=torch.uint8)
        with open(self.path, "rb") as f:
            f.seek(self._data_start + begin)
            if f.readinto(raw.numpy()) != end - begin:
                raise ValueError(f"{self.path}: tensor {name!r} truncated")
        return raw.view(dtype).reshape(shape)


def save_tensors(path: str, tensors: Dict[str, torch.Tensor],
                 metadata: Optional[Dict[str, str]] = None) -> None:
    """Write `tensors` (any device; in this order, back to back) and
    `metadata` (strings) as one safetensors file at `path`."""
    header, offset = {}, 0
    for name, t in tensors.items():
        if t.dtype not in _CODES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} is not "
                             f"writable; writable: {sorted(DTYPES)}")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    if metadata:
        header["__metadata__"] = metadata
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)  # the data starts 8-byte aligned
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            flat = t.detach().to("cpu").contiguous().reshape(-1)
            f.write(memoryview(flat.view(torch.uint8).numpy()))
    os.replace(tmp, path)


def open_checkpoint(checkpoint_dir: str) -> Dict[str, TensorFile]:
    """Name → the file holding it, over a checkpoint directory: the shards
    of `model.safetensors.index.json` where it exists, else every
    `*.safetensors` file in the directory."""
    index_path = os.path.join(checkpoint_dir, INDEX_NAME)
    if os.path.exists(index_path):
        with open(index_path) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
    else:
        files = sorted(f for f in os.listdir(checkpoint_dir)
                       if f.endswith(".safetensors"))
    handles = {}
    for fn in files:
        tf = TensorFile(os.path.join(checkpoint_dir, fn))
        for key in tf.keys():
            handles[key] = tf
    return handles

"""A reader and a writer of the safetensors format, with no dependency
beyond numpy and torch.

The format: an 8-byte little-endian header length N, N bytes of JSON
mapping each tensor name to ``{"dtype", "shape", "data_offsets": [begin,
end]}`` (offsets relative to the end of the header; an optional
``"__metadata__"`` entry of strings), then the raw little-endian tensor
bytes.

Reading maps each file with ``numpy.memmap`` (copy-on-write, so nothing is
read until a tensor is touched and nothing is written back) and hands out
CPU tensors that view the map: bf16 stays its raw 16 bits, viewed as
``torch.bfloat16``, with no fp32 copy on the host. A 3B checkpoint is then
moved to the device tensor by tensor instead of being widened on the host.
"""

from __future__ import annotations

import glob
import json
import os
import struct
from typing import Callable, Dict, List

import numpy as np
import torch

# safetensors dtype tag -> (numpy dtype of the raw bytes, torch dtype)
_DTYPES = {
    "F64": (np.float64, torch.float64),
    "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16),
    "BF16": (np.uint16, torch.bfloat16),
    "I64": (np.int64, torch.int64),
    "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16),
    "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8),
    "BOOL": (np.bool_, torch.bool),
}
_TAGS = {t: tag for tag, (_, t) in _DTYPES.items()}


def read_header(path: str):
    """(header dict without ``__metadata__``, byte offset of the data)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


class SafetensorsFile:
    """One ``.safetensors`` file; ``get(name)`` returns a CPU tensor that
    views the file's memory map (no copy)."""

    def __init__(self, path: str):
        self.path = path
        self.header, self._offset = read_header(path)
        self._map = None

    def keys(self):
        return self.header.keys()

    def get(self, name: str) -> torch.Tensor:
        info = self.header[name]
        np_dtype, t_dtype = _DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if self._map is None:
            self._map = np.memmap(self.path, dtype=np.uint8, mode="c")
        raw = self._map[self._offset + begin:self._offset + end]
        arr = raw.view(np_dtype).reshape(shape)
        t = torch.from_numpy(arr)
        return t.view(t_dtype) if t_dtype == torch.bfloat16 else t


def open_checkpoint(path: str) -> Callable[[str], torch.Tensor]:
    """``get(name) -> CPU tensor`` over every ``*.safetensors`` file of a
    directory (a sharded checkpoint), or over one file. ``get.names`` is the
    set of all tensor names; an unknown name raises KeyError."""
    files = ([path] if os.path.isfile(path)
             else sorted(glob.glob(os.path.join(path, "*.safetensors"))))
    if not files:
        raise FileNotFoundError(f"no safetensors under {path}")
    index: Dict[str, SafetensorsFile] = {}
    for f in files:
        sf = SafetensorsFile(f)
        for name in sf.keys():
            index[name] = sf

    def get(name: str) -> torch.Tensor:
        sf = index.get(name)
        if sf is None:
            raise KeyError(name)
        return sf.get(name)

    get.names = set(index)  # type: ignore[attr-defined]
    return get


def save_file(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` (any device; copied to the host one at a time) as
    one safetensors file. Tensors are laid out in name order, back to back;
    the header is padded with spaces to a multiple of 8 bytes."""
    names = sorted(tensors)
    header: dict = {}
    pos = 0
    for name in names:
        t = tensors[name]
        if t.dtype not in _TAGS:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors tag")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _TAGS[t.dtype], "shape": list(t.shape),
                        "data_offsets": [pos, pos + n]}
        pos += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in names:
            f.write(_raw_bytes(tensors[name]))


def _raw_bytes(t: torch.Tensor) -> memoryview:
    t = t.detach().contiguous().to("cpu")
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return memoryview(t.numpy().reshape(-1).view(np.uint8))


def save_sharded(tensors: Dict[str, torch.Tensor], directory: str,
                 shards: int = 1) -> List[str]:
    """Split ``tensors`` by name order over ``shards`` files
    ``model-0000i-of-0000n.safetensors`` in ``directory``
    (``model.safetensors`` for one shard); returns the paths written."""
    os.makedirs(directory, exist_ok=True)
    names = sorted(tensors)
    paths = []
    for i in range(shards):
        part = {n: tensors[n] for n in names[i::shards]}
        fname = ("model.safetensors" if shards == 1 else
                 f"model-{i + 1:05d}-of-{shards:05d}.safetensors")
        paths.append(os.path.join(directory, fname))
        save_file(part, paths[-1])
    return paths

"""A safetensors reader and writer in the standard library and numpy.

No JAX counterpart: the JAX package reads a checkpoint through
``transformers`` (``AutoModelForCausalLM.from_pretrained``,
``serve/units/causal_lm.py:263``), which the machine with the card does not
have. The format is small: an 8-byte little-endian header length, a JSON
header naming each tensor's dtype, shape and byte range, then the data.

:class:`Checkpoint` opens a single ``*.safetensors`` file or a directory
(one file, or shards named by ``model.safetensors.index.json``), maps each
file with ``np.memmap`` and hands out one tensor at a time on the device
asked for, so host memory never holds the model. ``BF16``, ``F16``,
``F32`` and ``I8`` are read (numpy has no bfloat16: it travels as
``uint16`` and is viewed as bfloat16 in torch). A directory holding only
``pytorch_model.bin`` is refused: a pickle is not read here.

:func:`save_safetensors` and :func:`save_sharded` write the same format
(``chip_smoke.py`` and the tests write their own checkpoints).
"""

from __future__ import annotations

import json
import os
import struct
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .device import DeviceLike

#: safetensors dtype -> (numpy storage dtype, torch dtype)
DTYPES = {
    "BF16": (np.uint16, torch.bfloat16),
    "F16": (np.float16, torch.float16),
    "F32": (np.float32, torch.float32),
    "I8": (np.int8, torch.int8),
}
_BY_TORCH = {tdt: (name, ndt) for name, (ndt, tdt) in DTYPES.items()}

INDEX = "model.safetensors.index.json"
SINGLE = "model.safetensors"

PathLike = Union[str, os.PathLike]


def read_header(path: PathLike) -> Tuple[int, Dict]:
    """``(data offset, header dict)`` of one safetensors file."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file (short header)")
        (n,) = struct.unpack("<Q", raw)
        header = json.loads(f.read(n))
    return 8 + n, header


class _File:
    """One mapped safetensors file."""

    def __init__(self, path: Path):
        self.path = path
        self.offset, header = read_header(path)
        header.pop("__metadata__", None)
        self.entries = header
        # copy-on-write: writable views for torch.from_numpy without
        # touching the file; pages are read when a tensor is copied out
        self.map = np.memmap(path, dtype=np.uint8, mode="c")

    def array(self, name: str) -> np.ndarray:
        e = self.entries[name]
        if e["dtype"] not in DTYPES:
            raise ValueError(f"{self.path}: tensor {name!r} has dtype "
                             f"{e['dtype']}; this reader takes "
                             f"{', '.join(DTYPES)}")
        begin, end = e["data_offsets"]
        ndt = np.dtype(DTYPES[e["dtype"]][0])
        shape = tuple(e["shape"])
        if end - begin != ndt.itemsize * int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{self.path}: tensor {name!r}: byte range "
                             f"{begin}..{end} does not hold {shape} "
                             f"{e['dtype']}")
        raw = self.map[self.offset + begin: self.offset + end]
        return raw.view(ndt).reshape(shape)


class Checkpoint:
    """The tensors of a safetensors checkpoint: ``path`` is a file or a
    directory. ``keys()`` lists them, ``dtype(name)`` and ``shape(name)``
    describe one without reading it, ``tensor(name, device)`` reads one."""

    def __init__(self, path: PathLike):
        path = Path(path)
        files: List[Path]
        if path.is_file():
            files = [path]
        elif (path / INDEX).is_file():
            index = json.loads((path / INDEX).read_text())
            files = sorted({path / f for f in index["weight_map"].values()})
        elif (path / SINGLE).is_file():
            files = [path / SINGLE]
        else:
            files = sorted(path.glob("*.safetensors")) if path.is_dir() \
                else []
            if not files:
                bins = sorted(p.name for p in path.glob("*.bin")) \
                    if path.is_dir() else []
                raise ValueError(
                    f"{path}: no safetensors checkpoint"
                    + (f" (found {', '.join(bins)}: PyTorch pickles are not "
                       f"read; convert the checkpoint to safetensors)"
                       if bins else ""))
        self.files = [_File(f) for f in files]
        self._where: Dict[str, _File] = {}
        for f in self.files:
            for name in f.entries:
                if name in self._where:
                    raise ValueError(f"tensor {name!r} is in both "
                                     f"{self._where[name].path} and {f.path}")
                self._where[name] = f

    def keys(self) -> List[str]:
        return list(self._where)

    def __contains__(self, name: str) -> bool:
        return name in self._where

    def dtype(self, name: str) -> str:
        return self._where[name].entries[name]["dtype"]

    def shape(self, name: str) -> Tuple[int, ...]:
        return tuple(self._where[name].entries[name]["shape"])

    def tensor(self, name: str, device: DeviceLike = "cpu") -> torch.Tensor:
        """The tensor ``name`` on ``device``, read from its file now (a
        CPU tensor is a copy, not a view of the map)."""
        arr = self._where[name].array(name)
        t = torch.from_numpy(arr).view(DTYPES[self.dtype(name)][1])
        if torch.device(device).type == "cpu":
            return t.clone()
        return t.to(device)


def _dtype_name(t: torch.Tensor) -> str:
    if t.dtype not in _BY_TORCH:
        raise ValueError(f"cannot write dtype {t.dtype}; this writer takes "
                         f"{', '.join(str(d) for d in _BY_TORCH)}")
    return _BY_TORCH[t.dtype][0]


def _bytes_of(t: torch.Tensor) -> bytes:
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def save_safetensors(tensors: Dict[str, torch.Tensor], path: PathLike,
                     metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` as one safetensors file (header padded to 8
    bytes, as the format's own writer pads it), one tensor's bytes on the
    host at a time."""
    header: Dict = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    pos = 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _dtype_name(t), "shape": list(t.shape),
                        "data_offsets": [pos, pos + n]}
        pos += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            f.write(_bytes_of(t))


def save_sharded(tensors: Dict[str, torch.Tensor], directory: PathLike,
                 n_shards: int) -> List[Path]:
    """Write ``tensors`` as ``n_shards`` files of about equal bytes,
    ``model-0000i-of-0000n.safetensors``, with the index naming each
    tensor's file."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    names = list(tensors)
    total = sum(tensors[n].numel() * tensors[n].element_size() for n in names)
    shards: List[Dict[str, torch.Tensor]] = [{} for _ in range(n_shards)]
    acc = 0
    for n in names:
        i = min(n_shards - 1, acc * n_shards // max(total, 1))
        shards[i][n] = tensors[n]
        acc += tensors[n].numel() * tensors[n].element_size()
    paths, weight_map = [], {}
    for i, shard in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{n_shards:05d}.safetensors"
        save_safetensors(shard, directory / fname, {"format": "pt"})
        paths.append(directory / fname)
        weight_map.update({n: fname for n in shard})
    (directory / INDEX).write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map},
        indent=2))
    return paths

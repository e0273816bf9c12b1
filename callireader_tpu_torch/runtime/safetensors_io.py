"""The safetensors format, read and written without the ``safetensors``
package (the port's stand-in for it).

A file is an 8-byte little-endian header length, a JSON header
``{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{str: str}?}`` and the raw little-endian buffer the offsets index (from the
end of the header). The reader maps a file with ``np.memmap`` (copy on
write: the tensors are writable and the file is never changed) and hands out
CPU tensors in their stored dtype that read their bytes when touched; BF16
is read as uint16 and viewed as ``torch.bfloat16``. The writer pads the
header with spaces to a multiple of 8 bytes, as the library does, and
writes each tensor's bytes as it comes: a CPU tensor's from its own memory,
a device tensor's through one reused pinned buffer, a chunk at a time (a
fresh pageable copy of each tensor would fault its pages in first). A
sharded export holds no tensor on the host.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

# format name -> (torch dtype, numpy dtype of the stored bytes)
DTYPES = {
    "F32": (torch.float32, np.float32),
    "F16": (torch.float16, np.float16),
    "BF16": (torch.bfloat16, np.uint16),
    "I8": (torch.int8, np.int8),
    "I32": (torch.int32, np.int32),
    "I64": (torch.int64, np.int64),
    "U8": (torch.uint8, np.uint8),
    "BOOL": (torch.bool, np.bool_),
}
NAMES = {t: name for name, (t, _) in DTYPES.items()}
INDEX_FILE = "model.safetensors.index.json"
STAGING_BYTES = 64 << 20  # the pinned buffer a device tensor's bytes pass through


def read_header(path: str) -> Tuple[Dict, int]:
    """-> (header without ``__metadata__``, with it under that key; the
    byte offset of the buffer)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    return header, 8 + n


def read_metadata(path: str) -> Dict[str, str]:
    return read_header(path)[0].get("__metadata__", {})


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one file, in the order of their bytes (the library's
    ``load_file`` order), as memory-mapped CPU tensors in their stored
    dtype."""
    header, start = read_header(path)
    entries = sorted(((k, v) for k, v in header.items() if k != "__metadata__"),
                     key=lambda kv: tuple(kv[1]["data_offsets"]))
    size = os.path.getsize(path)
    buf = np.memmap(path, dtype=np.uint8, mode="c") if size > start else None
    out: Dict[str, torch.Tensor] = {}
    for name, info in entries:
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which the reader "
                             f"does not cover ({sorted(DTYPES)})")
        tdtype, ndtype = DTYPES[info["dtype"]]
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        itemsize = np.dtype(ndtype).itemsize
        if end - begin != int(np.prod(shape, dtype=np.int64)) * itemsize or start + end > size:
            raise ValueError(f"{path}: {name} holds bytes [{begin}, {end}), which do not fit "
                             f"shape {list(shape)} of {info['dtype']} in a file of {size} bytes")
        if end == begin:
            a = np.empty(shape, ndtype)
        else:
            raw = buf[start + begin:start + end]
            if (start + begin) % itemsize:
                raw = raw.copy()  # an unaligned tensor: its own aligned bytes
            a = raw.view(ndtype).reshape(shape)
        t = torch.from_numpy(a)
        out[name] = t.view(torch.bfloat16) if tdtype == torch.bfloat16 else t
    return out


class _Stager:
    """Writes tensors' row-major bytes to files; a device tensor's go through
    one pinned buffer, allocated at the first of them."""

    def __init__(self):
        self.buf = None

    def write(self, f, t: torch.Tensor) -> None:
        flat = t.detach().contiguous().reshape(-1).view(torch.uint8)
        if flat.device.type == "cpu":
            f.write(flat.numpy())
            return
        if self.buf is None:
            self.buf = torch.empty(STAGING_BYTES, dtype=torch.uint8, pin_memory=True)
        for i in range(0, flat.numel(), STAGING_BYTES):
            chunk = self.buf[:min(STAGING_BYTES, flat.numel() - i)]
            chunk.copy_(flat[i:i + chunk.numel()])
            f.write(chunk.numpy())


class Entry:
    """A tensor to write: its name, dtype and shape, and ``make()`` giving it
    (called once, when its bytes are written)."""

    def __init__(self, name: str, dtype: torch.dtype, shape: Sequence[int],
                 make: Callable[[], torch.Tensor]):
        if dtype not in NAMES:
            raise ValueError(f"{name}: dtype {dtype} is not one the format covers")
        self.name, self.dtype, self.shape, self.make = name, dtype, tuple(shape), make
        self.nbytes = int(np.prod(self.shape, dtype=np.int64)) * torch.empty(
            (), dtype=dtype).element_size()

    @classmethod
    def of(cls, name: str, t: torch.Tensor, dtype: Optional[torch.dtype] = None) -> "Entry":
        """``t`` written as ``dtype`` (default its own), cast on its device
        when its bytes are written."""
        dtype = dtype or t.dtype
        return cls(name, dtype, t.shape, lambda: t.to(dtype))


def write_entries(path: str, entries: Sequence[Entry],
                  metadata: Optional[Dict[str, str]] = None,
                  stager: Optional[_Stager] = None) -> None:
    """One safetensors file of ``entries``, in their order."""
    stager = stager or _Stager()
    header: Dict = {}
    if metadata is not None:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for e in entries:
        header[e.name] = {"dtype": NAMES[e.dtype], "shape": list(e.shape),
                          "data_offsets": [offset, offset + e.nbytes]}
        offset += e.nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for e in entries:
            t = e.make()
            if t.dtype != e.dtype or tuple(t.shape) != e.shape:
                raise ValueError(f"{e.name}: made {t.dtype} {tuple(t.shape)}, announced "
                                 f"{e.dtype} {e.shape}")
            if e.nbytes:
                stager.write(f, t)


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """``tensors`` (any device) as one file, in the dict's order."""
    write_entries(path, [Entry.of(k, v) for k, v in tensors.items()], metadata)


def plan_shards(entries: Iterable[Entry], max_shard_bytes: Optional[int]) -> List[List[Entry]]:
    """Consecutive runs of ``entries``, a new one whenever the next tensor
    would take the run past ``max_shard_bytes`` (a tensor larger than the
    cap gets a run of its own); one run when there is no cap."""
    shards: List[List[Entry]] = [[]]
    size = 0
    for e in entries:
        if max_shard_bytes and size + e.nbytes > max_shard_bytes and shards[-1]:
            shards.append([])
            size = 0
        shards[-1].append(e)
        size += e.nbytes
    return shards


def write_sharded(out_dir: str, entries: Sequence[Entry],
                  max_shard_bytes: Optional[int] = None) -> List[str]:
    """``model.safetensors``, or ``model-0000i-of-0000n.safetensors`` when the
    cap splits the entries, beside ``model.safetensors.index.json``
    (``{"metadata": {"total_size"}, "weight_map": {name: file}}``) -> the
    files written."""
    os.makedirs(out_dir, exist_ok=True)
    shards = plan_shards(entries, max_shard_bytes)
    n = len(shards)
    names = (["model.safetensors"] if n == 1 else
             [f"model-{i + 1:05d}-of-{n:05d}.safetensors" for i in range(n)])
    weight_map, stager = {}, _Stager()
    for name, shard in zip(names, shards):
        write_entries(os.path.join(out_dir, name), shard, stager=stager)
        weight_map.update({e.name: name for e in shard})
    index = {"metadata": {"total_size": sum(e.nbytes for e in entries)},
             "weight_map": weight_map}
    with open(os.path.join(out_dir, INDEX_FILE), "w") as f:
        json.dump(index, f, indent=2)
    return [os.path.join(out_dir, name) for name in names]


def shard_files(path: str) -> List[str]:
    """The shards of a directory: those its index names, else every
    ``*.safetensors`` in it (sorted)."""
    index = os.path.join(path, INDEX_FILE)
    if os.path.exists(index):
        with open(index) as f:
            return sorted(set(json.load(f)["weight_map"].values()))
    return sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))

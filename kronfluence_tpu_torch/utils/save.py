"""Persistence helpers: safetensors + JSON. Port of `kronfluence_tpu/utils/save.py`.

The safetensors format is written and read here in plain Python, so the port
needs no `safetensors` package: an 8-byte little-endian header length, a
JSON header mapping each name to its `dtype`, `shape` and `data_offsets`
(with an optional `__metadata__` of strings), padded with spaces to 8 bytes,
then the raw little-endian bytes. Files are interchangeable with the JAX
package's (and the reference's): the same names, dtypes and layout.

Every tensor is moved as bytes (`view(torch.uint8)`), so bf16, which numpy
lacks, needs no conversion. A file's tensors come to the host in one copy:
their bytes are concatenated on their device first. Loading reads the file
once and moves its bytes to the target device in one copy; the tensors are
views into that buffer.
"""

import json
import struct
import sys
from pathlib import Path
from typing import Any, Dict, NamedTuple, Optional

import torch

_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
}
_NAMES = {dtype: name for name, dtype in _DTYPES.items()}

if sys.byteorder != "little":  # the format is little-endian; the buffers are raw memory
    raise ImportError("kronfluence_tpu_torch.utils.save needs a little-endian host.")


class HostFile(NamedTuple):
    """A safetensors file held on the host: its header and its byte buffer."""

    header: bytes
    data: torch.Tensor  # uint8, on the CPU


def to_host(
    tensors: Dict[str, torch.Tensor], metadata: Optional[Dict[str, str]] = None
) -> HostFile:
    """Serializes `tensors` with one device-to-host copy for the whole file.

    Integer tensors persist as int64 vectors (counts are int64 singletons, as
    in the reference's artifacts). Entries are laid out by descending item
    size, then name, as the safetensors writer does, so every offset is
    aligned to its dtype.
    """
    prepared = {}
    for name, t in tensors.items():
        if not t.is_floating_point():
            t = t.reshape(-1).to(torch.int64)
        if t.dtype not in _NAMES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors name here.")
        prepared[name] = t.detach()
    order = sorted(prepared, key=lambda n: (-prepared[n].element_size(), n))
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    parts, offset = [], 0
    for name in order:
        t = prepared[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {
            "dtype": _NAMES[t.dtype],
            "shape": list(t.shape),
            "data_offsets": [offset, offset + nbytes],
        }
        parts.append(t.contiguous().reshape(-1).view(torch.uint8))
        offset += nbytes
    devices = {p.device for p in parts}
    if len(devices) > 1:
        parts = [p.cpu() for p in parts]
    data = torch.cat(parts).cpu() if parts else torch.empty(0, dtype=torch.uint8)
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-len(text) % 8)
    return HostFile(struct.pack("<Q", len(text)) + text, data)


def write_host_file(host: HostFile, filename: Path) -> None:
    """Writes a serialized file (file I/O only; safe on a background thread)."""
    filename = Path(filename)
    filename.parent.mkdir(parents=True, exist_ok=True)
    with open(filename, "wb") as f:
        f.write(host.header)
        f.write(memoryview(host.data.numpy()))


def save_file(
    tensors: Dict[str, torch.Tensor], filename: Path, metadata: Optional[Dict[str, str]] = None
) -> None:
    write_host_file(to_host(tensors, metadata), filename)


def load_file(filename: Path, device: Any = "cpu") -> Dict[str, torch.Tensor]:
    """{name: tensor} of a safetensors file, on `device`."""
    filename = Path(filename)
    if not filename.exists():
        raise FileNotFoundError(f"File does not exist at {filename}.")
    size = filename.stat().st_size
    with open(filename, "rb") as f:
        prefix = f.read(8)
        if len(prefix) < 8:
            raise ValueError(f"{filename} is not a safetensors file: {size} bytes.")
        (header_len,) = struct.unpack("<Q", prefix)
        if 8 + header_len > size:
            raise ValueError(f"{filename}: header length {header_len} exceeds the file.")
        header = json.loads(f.read(header_len).decode("utf-8"))
        buffer = torch.empty(size - 8 - header_len, dtype=torch.uint8)
        if f.readinto(memoryview(buffer.numpy())) != buffer.numel():
            raise ValueError(f"{filename} was truncated while it was read.")
    header.pop("__metadata__", None)
    buffer = buffer.to(device)
    out = {}
    for name, entry in header.items():
        if entry["dtype"] not in _DTYPES:
            raise TypeError(f"{filename}: {name} has dtype {entry['dtype']}, not supported here.")
        dtype = _DTYPES[entry["dtype"]]
        begin, end = entry["data_offsets"]
        shape = [int(d) for d in entry["shape"]]
        itemsize = torch.empty((), dtype=dtype).element_size()
        count = 1
        for d in shape:
            count *= d
        if not 0 <= begin <= end <= buffer.numel() or end - begin != count * itemsize:
            raise ValueError(f"{filename}: {name} has offsets {entry['data_offsets']} "
                             f"that do not fit {entry['dtype']}{shape}.")
        chunk = buffer[begin:end]
        if begin % itemsize:  # a foreign file's unaligned entry: copy it to aligned memory
            chunk = chunk.clone()
        out[name] = chunk.view(dtype).reshape(shape)
    return out


def save_json(obj: Any, path: Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=4, sort_keys=True)


def load_json(path: Path) -> Any:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def verify_models_equivalence(
    state_dict1: Dict[str, torch.Tensor], state_dict2: Dict[str, torch.Tensor]
) -> bool:
    """allclose comparison of two flat parameter dicts (rtol 1.3e-6, atol 1e-5, in fp32)."""
    if state_dict1.keys() != state_dict2.keys():
        return False
    for name in state_dict1:
        a = state_dict1[name].detach().to("cpu", torch.float32)
        b = state_dict2[name].detach().to("cpu", torch.float32)
        if a.shape != b.shape or not torch.allclose(a, b, rtol=1.3e-6, atol=1e-5):
            return False
    return True

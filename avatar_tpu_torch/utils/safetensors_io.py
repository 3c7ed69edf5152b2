"""Reader and writer of the safetensors format, with no ``safetensors``
package (port of ``avatar_tpu/utils/safetensors_io.py``).

A file is an 8-byte little-endian header length N, an N-byte JSON header
``{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{str: str}}`` (padded with spaces), then the tensors' raw little-endian
bytes, each at its offsets from the end of the header. bf16 is stored as
its raw 16-bit patterns. Single-file checkpoints keep their JSON config
under the ``config`` metadata key.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _header(path: Union[str, Path]) -> Tuple[dict, int]:
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        return json.loads(f.read(n)), 8 + n


def load_safetensors(
    path: Union[str, Path],
) -> Tuple[Dict[str, torch.Tensor], Dict[str, str]]:
    """Every tensor (CPU torch tensors, their stored dtypes) and the
    metadata of a safetensors file."""
    header, start = _header(path)
    metadata = header.pop("__metadata__", None) or {}
    data = Path(path).read_bytes()
    tensors = {}
    for name, info in header.items():
        begin, end = info["data_offsets"]
        dtype = _DTYPES[info["dtype"]]
        buf = bytearray(data[start + begin:start + end])
        flat = (torch.frombuffer(buf, dtype=dtype) if buf
                else torch.empty(0, dtype=dtype))
        tensors[name] = flat.reshape(info["shape"])
    return tensors, metadata


def _as_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().contiguous()
    return torch.from_numpy(np.ascontiguousarray(value))


def save_safetensors(
    tensors: Dict[str, Union[torch.Tensor, np.ndarray]],
    path: Union[str, Path],
    metadata: Optional[Dict[str, str]] = None,
) -> None:
    """Write ``tensors`` (torch tensors or numpy arrays; bf16 as torch
    tensors) in name order, and ``metadata`` (str -> str)."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blobs, offset = [], 0
    for name in sorted(tensors):
        t = _as_tensor(tensors[name])
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in blobs:
            f.write(raw)


def load_config_metadata(path: Union[str, Path]) -> dict:
    """The JSON ``config`` metadata of a single-file checkpoint."""
    header, _ = _header(path)
    metadata = header.get("__metadata__") or {}
    if "config" not in metadata:
        raise ValueError(f"No 'config' metadata in {path}")
    return json.loads(metadata["config"])

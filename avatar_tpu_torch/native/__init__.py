"""Native (C) components, built on first use against system libraries
(port of ``avatar_tpu/native``, with its own copy of ``crf_codec.c``).

``crf_roundtrip`` is the exact H.264-CRF compressor of conditioning images,
against the system libavcodec / libx264 through a small C shim, loaded with
``ctypes``. When the compiler or the codec libraries are absent it returns
None and the caller takes its next backend.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_HERE = Path(__file__).resolve().parent
_LOCK = threading.Lock()
_LIB = {"crf": "unloaded"}


def _build_crf_lib() -> Optional[Path]:
    """Compile ``crf_codec.c`` into a cached shared object (in ``_build``
    beside it, or ``AVATAR_TPU_TORCH_NATIVE_CACHE``); None on failure."""
    src = _HERE / "crf_codec.c"
    cache = Path(os.environ.get("AVATAR_TPU_TORCH_NATIVE_CACHE", _HERE / "_build"))
    so = cache / "libavatar_crf.so"
    if so.exists() and so.stat().st_mtime >= src.stat().st_mtime:
        return so
    try:
        flags = subprocess.run(
            ["pkg-config", "--cflags", "--libs", "libavcodec", "libavutil", "libswscale"],
            capture_output=True, text=True, check=True,
        ).stdout.split()
        cache.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".so.{os.getpid()}.tmp")
        subprocess.run(["gcc", "-O2", "-shared", "-fPIC", str(src), "-o", str(tmp)] + flags,
                       capture_output=True, text=True, check=True)
        os.replace(tmp, so)
        return so
    except (OSError, subprocess.CalledProcessError):
        return None


def _crf_lib():
    with _LOCK:
        if _LIB["crf"] == "unloaded":
            so = _build_crf_lib()
            lib = None
            if so is not None:
                try:
                    lib = ctypes.CDLL(str(so))
                    lib.avatar_crf_roundtrip_rgb.restype = ctypes.c_int
                    lib.avatar_crf_roundtrip_rgb.argtypes = [
                        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
                    ]
                except OSError:
                    lib = None
            _LIB["crf"] = lib
        return _LIB["crf"]


def crf_roundtrip(rgb: np.ndarray, crf: int) -> Optional[np.ndarray]:
    """H.264 round trip of a [H, W, 3] uint8 RGB image (even H and W) at
    ``crf`` through the native shim: the decoded uint8 array, or None when
    the shim is unavailable or fails."""
    lib = _crf_lib()
    if lib is None:
        return None
    arr = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w = arr.shape[:2]
    out = np.empty_like(arr)
    rc = lib.avatar_crf_roundtrip_rgb(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h, int(crf),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out if rc == 0 else None

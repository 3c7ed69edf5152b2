"""Build and load the hand-written CUDA kernels of ``avatar_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. The
library's file name carries a hash of the sources, so an edit rebuilds it.
Libraries go to ``csrc/build/`` (git-ignored). Nothing is built at import:
the first wrapper call builds its library, or :func:`build_all` builds
every one in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
KERNEL_SOURCES = (
    "rope_attention", "token_attention", "flash_forward", "flash_backward",
    "flash_dense", "int8_matmul", "row_quant",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas register/shared-memory report of each library built by this process
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str, out: Path) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )


def _finish(name: str, out: Path, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    build_logs[name] = log


def build_all(names: Sequence[str] = KERNEL_SOURCES) -> Dict[str, ctypes.CDLL]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together; load them all. Raises if any build fails."""
    with _lock:
        pending = {}
        for name in names:
            out = _lib_path(name)
            if name not in _libs and not out.exists():
                pending[name] = (out, _start(name, out))
        errors = []
        for name, (out, proc) in pending.items():
            try:
                _finish(name, out, proc)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        for name in names:
            if name not in _libs:
                _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return {name: _libs[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    return lib if lib is not None else build_all([name])[name]

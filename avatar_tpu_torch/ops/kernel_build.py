"""Build and load the hand-written CUDA kernels of ``avatar_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. A
source may be built in several variants, each a tuple of ``-D`` defines
(the attention sources take ``ATTN_F32=1`` for f32 and ``ATTN_D=<padded
head dim>``; no defines is the bf16 / 64 build), one library per variant.
The library's file name carries a hash of the sources, the flags and the
defines, so an edit rebuilds it. Libraries go to ``csrc/build/``
(git-ignored). Nothing is built at import: the first wrapper call builds
its library, or :func:`build_all` builds a list of them in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, List, Tuple, Union

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
KERNEL_SOURCES = (
    "rope_attention", "rope_attention_sm90", "token_attention", "token_attention_sm90",
    "flash_forward", "flash_forward_sm90", "flash_backward", "flash_backward_sm90",
    "flash_dense", "flash_dense_sm90", "int8_matmul", "int8_matmul_sm90", "row_quant",
    "int8_conv3d", "int8_conv3d_sm90", "qk_norm_rope",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

Defines = Tuple[str, ...]
Spec = Tuple[str, Defines]

_lock = threading.Lock()
_libs: Dict[Spec, ctypes.CDLL] = {}
# ptxas register/shared-memory report and wall seconds of each library
# built by this process, by label ("name" or "name[DEF=1,...]")
build_logs: Dict[str, str] = {}
build_seconds: Dict[str, float] = {}


def label(name: str, defines: Defines = ()) -> str:
    return f"{name}[{','.join(defines)}]" if defines else name


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


def _lib_path(name: str, defines: Defines = ()) -> Path:
    digest = hashlib.sha256()
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + defines).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _build(name: str, defines: Defines, out: Path) -> None:
    """One ``nvcc`` run; records its log and seconds, raises on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {label(name, defines)}:\n{proc.stdout}")
    os.replace(tmp, out)
    build_seconds[label(name, defines)] = time.perf_counter() - t0
    build_logs[label(name, defines)] = proc.stdout


def _spec(item: Union[str, Spec]) -> Spec:
    return (item, ()) if isinstance(item, str) else (item[0], tuple(item[1]))


def build_all(items: Iterable[Union[str, Spec]] = KERNEL_SOURCES
              ) -> Dict[Spec, ctypes.CDLL]:
    """Compile every missing library of ``items`` (source names, built
    without defines, or ``(name, defines)`` pairs), one ``nvcc`` per
    library, all started together; load them all. Raises if any build
    fails."""
    specs: List[Spec] = [_spec(i) for i in items]
    with _lock:
        pending = [(spec, _lib_path(*spec)) for spec in dict.fromkeys(specs)
                   if spec not in _libs]
        pending = [(spec, out) for spec, out in pending if not out.exists()]
        errors = []
        if pending:
            with ThreadPoolExecutor(max_workers=len(pending)) as pool:
                futures = [pool.submit(_build, *spec, out) for spec, out in pending]
                for fut in futures:
                    try:
                        fut.result()
                    except RuntimeError as e:
                        errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        for spec in specs:
            if spec not in _libs:
                _libs[spec] = ctypes.CDLL(str(_lib_path(*spec)))
        return {spec: _libs[spec] for spec in specs}


def load(name: str, defines: Defines = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` built with ``defines``,
    built on first use."""
    lib = _libs.get((name, defines))
    return lib if lib is not None else build_all([(name, defines)])[(name, defines)]

"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, named by a hash
of the source and the flags, under ``build/torch_kernels/`` at the root of
the checkout, and loaded with ``ctypes``.  Nothing is built or loaded when a
module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("group_norm_relu.cu", "fused_augment.cu", "int8_conv.cu",
           "quantize.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: dict = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``), else the
    ``nvcc`` on ``PATH``."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH)")
    return found


def library_path(source: str) -> Path:
    src = (CSRC / source).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{Path(source).stem}-{digest[:16]}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its library already exists."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {source} ({proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # concurrent builders never load a partial file
    return out


def build_all() -> list:
    """Compile every source, one ``nvcc`` per source, all started
    together; their paths, in ``SOURCES`` order."""
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        return list(pool.map(build, SOURCES))


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built at first use."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            _loaded[source] = lib
        return lib

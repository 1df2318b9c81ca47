"""Compile the repo-level ``native/*.cpp`` sources the port binds with
ctypes (the TIFF reader, the PNG decoder).

Each library is compiled with ``g++`` at first use into ``build/native/``
at the root of the checkout, named by a hash of its sources and the
command, written to a temporary name and moved into place, so concurrent
builds (test workers, threads) never load a partial file.  Both need zlib's
headers and library: when the build fails it raises with the compiler's
output.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence

_ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = _ROOT / "native"
BUILD_DIR = _ROOT / "build" / "native"
# portable codegen (no -march=native): a cached binary must not SIGILL on a
# host lacking the build machine's ISA
BUILD_CMD = ("g++", "-O3", "-std=c++17", "-fPIC", "-shared")
LIBS = ("-lz", "-lpthread")


def library_path(stem: str, sources: Sequence[str]) -> Path:
    """``build/native/<stem>-<hash>.so`` for the current ``sources``."""
    blob = b"".join((NATIVE_DIR / name).read_bytes() for name in sources)
    digest = hashlib.sha256(
        blob + " ".join(BUILD_CMD + LIBS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{stem}-{digest}.so"


def build(stem: str, sources: Sequence[str], what: str) -> Path:
    """Compile ``sources`` unless their library already exists; raises
    ``RuntimeError`` naming ``what`` with the compiler's output when the
    build fails (for example without ``g++`` or zlib's headers)."""
    out = library_path(stem, sources)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(
        f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [*BUILD_CMD, "-o", str(tmp),
           *(str(NATIVE_DIR / n) for n in sources), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except OSError as exc:  # no such compiler
        raise RuntimeError(f"building {what} failed (it needs g++ and "
                           f"zlib's headers): {exc}") from exc
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {what} failed ({proc.returncode}; it needs g++ and "
            f"zlib's headers):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out

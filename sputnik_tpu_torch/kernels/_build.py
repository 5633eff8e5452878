"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``_build/<name>-<hash>.so``, where the hash
covers the sources, the headers and the flags, so an edited source builds
anew and an unchanged one loads at once. The sources include no PyTorch
header and export plain C functions, so a build takes seconds. Nothing is
built when this module is imported: the first call to :func:`load` builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "load", "build_seconds", "ptxas_report"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# Seconds each library took to build in this process (0.0 when it was
# already built on disk).
build_seconds: dict = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and return the loaded library."""
    lib = BUILD_DIR / f"{name}-{_digest(name)}.so"
    start = time.perf_counter()
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # Build to a private name, then rename, so a concurrent loader never
        # sees a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed for {name}.cu ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, lib)
    build_seconds[name] = time.perf_counter() - start
    return ctypes.CDLL(str(lib))


def ptxas_report(name: str) -> list:
    """ptxas's resource report (``-Xptxas -v``) of every kernel of
    ``csrc/<name>.cu``: ``[(mangled name, registers, spill store bytes,
    spill load bytes, shared memory bytes)]``, from a device-only compile
    to a cubin in a temporary directory (the library is not touched)."""
    arch = [f for f in NVCC_FLAGS if f.startswith("arch=")]
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [_nvcc(), "-gencode", *arch, "-std=c++17", "-O3", "-cubin", "-Xptxas", "-v", "-I", str(CSRC),
               "-o", os.path.join(tmp, f"{name}.cubin"), str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -Xptxas -v failed for {name}.cu ({proc.returncode}):\n{proc.stderr}")
    rows, current = [], None
    for line in proc.stderr.splitlines():
        if "Compiling entry function" in line:
            current = [line.split("'")[1], 0, 0, 0, 0]
            rows.append(current)
        elif current is not None and "spill stores" in line:
            words = line.replace(",", " ").split()
            current[2] = int(words[words.index("spill") - 2])
            current[3] = int(words[words.index("loads") - 3])
        elif current is not None and "Used" in line and "registers" in line:
            words = line.replace(",", " ").split()
            current[1] = int(words[words.index("registers") - 1])
            if "smem" in words:
                current[4] = int(words[words.index("smem") - 2])
    return [tuple(r) for r in rows]

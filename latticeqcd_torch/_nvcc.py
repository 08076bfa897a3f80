"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (sm_90a) into
``_build/lib<name>-<hash>.so`` with a plain C interface and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). The hash
covers the sources and flags, so an edited source is never served from a
stale library. Nothing is built when a module is imported: callers ask
for a library the first time they launch one of its kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LOADED: dict = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in [src, *sorted(CSRC.glob("*.h"))]:
        digest.update(dep.read_bytes())
    return BUILD / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless an up-to-date library exists.

    The compiler's report (-Xptxas=-v: registers, spills) is kept beside
    the library as <lib>.log. Writes to a temporary name and renames, so
    processes building at once never load a half-written file."""
    lib = library_path(name)
    if lib.exists():
        return lib
    BUILD.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build(name)))
    return _LOADED[name]

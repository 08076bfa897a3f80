"""ctypes bridge to the host fast-IO helper (csrc/fastio.cpp).

A copy of latticeqcd_tpu/io/native_ext.py for the port. The helper is
host file parsing, not a device kernel: g++ builds it at first use into
``latticeqcd_torch/_build/libfastio-<hash>.so``, keyed by a hash of the
source as the CUDA libraries are (``_nvcc.py``). Every caller falls back
to NumPy, with a warning, when the library cannot be built or loaded,
so the native path only speeds up parsing a production-size text file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import warnings

import numpy as np

from latticeqcd_torch import _nvcc

_SRC = _nvcc.CSRC / "fastio.cpp"
_LIB = None
_TRIED = False


def library_path():
    return _nvcc.BUILD / f"libfastio-{hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]}.so"


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    sopath = library_path()
    if not sopath.exists():
        _nvcc.BUILD.mkdir(exist_ok=True)
        tmp = sopath.with_name(f"{sopath.name}.{os.getpid()}.tmp")
        try:
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
                check=True,
                capture_output=True,
                timeout=120,
            )
            os.replace(tmp, sopath)
        except (OSError, subprocess.SubprocessError) as e:
            warnings.warn(f"fastio build failed ({e}); using NumPy fallback")
            return None
    try:
        lib = ctypes.CDLL(str(sopath))
    except OSError:
        return None
    lib.parse_doubles.restype = ctypes.c_int64
    lib.parse_doubles.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
    ]
    lib.deinterleave.restype = None
    lib.deinterleave.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
    ]
    _LIB = lib
    return _LIB


def parse_text_doubles(filename, expected: int) -> np.ndarray:
    """Parse a whitespace-separated-doubles text file (fast path)."""
    lib = _load()
    if lib is None:
        return np.loadtxt(filename, dtype=np.float64).reshape(-1)
    with open(filename, "rb") as fp:
        raw = fp.read()
    out = np.empty(expected + 1, dtype=np.float64)
    n = lib.parse_doubles(
        raw,
        len(raw),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        expected + 1,
    )
    return out[:n]


def to_complex(data: np.ndarray) -> np.ndarray:
    """Interleaved re/im -> complex array (native deinterleave)."""
    lib = _load()
    n = data.size // 2
    if lib is None:
        return data[0::2] + 1j * data[1::2]
    re = np.empty(n, dtype=np.float64)
    im = np.empty(n, dtype=np.float64)
    data = np.ascontiguousarray(data, dtype=np.float64)
    lib.deinterleave(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n,
        re.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        im.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return re + 1j * im

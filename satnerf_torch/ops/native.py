"""ctypes loader for the C++ host kernels (``native/src/satnerf_native.cpp``).

The port compiles the repository's source with ``g++`` (the flags of
``native/Makefile``) into ``build/satnerf_torch/native-<hash>/`` at the
repository root (listed in ``.gitignore``), beside the CUDA builds of
``ops/_build.py``. The hash covers the source, the flags and the host CPU's
feature flags (``-march=native``), so a library built on one machine is never
loaded on another. Nothing is written into ``native/``.

``get_lib()`` returns None when no compiler is present or the build fails;
callers then take their vectorised numpy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "src", "satnerf_native.cpp")
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall")

_lib = None
_tried = False


def _cpu_flags() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return os.uname().machine.encode()


def lib_path() -> str:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode() + _cpu_flags())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(_REPO, "build", "satnerf_torch", f"native-{h.hexdigest()[:16]}",
                        "libsatnerf_native.so")


def _build(path: str) -> bool:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return False
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run([cxx, *CXXFLAGS, "-o", tmp, SOURCE], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.isfile(SOURCE):
        return None
    path = lib_path()
    if not os.path.isfile(path) and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None

    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.c_int64

    lib.sn_downsample2x.argtypes = [dp, i64, i64, dp]
    lib.sn_mean_std.argtypes = [dp, dp, i64, i64, ctypes.c_int, ctypes.c_int, dp]
    lib.sn_mean_std.restype = i64
    lib.sn_ncc_search.argtypes = [
        dp, dp, i64, i64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ip,
    ]
    lib.sn_apply_shift.argtypes = [
        dp, i64, i64, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double, dp,
    ]
    lib.sn_rasterize_mean.argtypes = [
        dp, i64, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        i64, i64, ctypes.c_int, dp, dp,
    ]
    lib.sn_lzw_decode.argtypes = [u8p, i64, u8p, i64]
    lib.sn_lzw_decode.restype = i64
    _lib = lib
    return _lib


def as_double_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def as_int_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def as_u8_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

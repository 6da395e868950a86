"""Build and load the CUDA kernels of ``satnerf_torch/csrc``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds). Outputs go to ``build/satnerf_torch/<hash>/`` at the
repository root (listed in ``.gitignore``), keyed by a hash of every source
and the flags, so an edited source never loads a stale library.

``build_all()`` starts one ``nvcc`` per source at once and waits for all.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
KERNELS = ("field_fused", "composite", "sine_check")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_vp, _i = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "field_fused": {"field_fused_forward": [_vp, _vp]},
    "composite": {"composite_forward": [_vp] * 9 + [_i, _i, _vp]},
    "sine_check": {"sine_eval": [_vp, _vp, _i, _i, _vp]},
}

_LIBS: dict = {}
_LOCK = threading.Lock()


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn.endswith((".cu", ".cuh")):
            h.update(fn.encode())
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def build_dir() -> str:
    repo = os.path.dirname(os.path.dirname(CSRC))
    return os.path.join(repo, "build", "satnerf_torch", _source_hash())


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return path


def lib_path(name: str) -> str:
    return os.path.join(build_dir(), f"lib{name}.so")


def build_all(names=KERNELS) -> dict:
    """Compile every missing library, one ``nvcc`` per source in parallel.

    Returns {name: seconds} for the libraries built now (0.0 when already
    built). ``-Xptxas -v`` output (registers, spills) lands in
    ``<build_dir>/<name>.log``. Raises with nvcc's output on failure.
    """
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    times = {}
    nvcc = _nvcc()
    for name in names:
        if os.path.exists(lib_path(name)):
            times[name] = 0.0
            continue
        tmp = f"{lib_path(name)}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
            tmp, time.monotonic(),
        )
    failures = []
    for name, (proc, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.monotonic() - t0
        with open(os.path.join(out_dir, f"{name}.log"), "w") as f:
            f.write(log)
        if proc.returncode != 0:
            failures.append(f"--- nvcc {name}.cu (rc {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, lib_path(name))
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return times


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``lib<name>.so``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if not os.path.exists(lib_path(name)):
                build_all((name,))
            lib = ctypes.CDLL(lib_path(name))
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.satnerf_cuda_error_string.argtypes = [ctypes.c_int]
            lib.satnerf_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib

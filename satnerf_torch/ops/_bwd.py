"""Launch helpers of the backward kernels K2 and K4 (``csrc/bwd_common.cuh``).

Two primitives, each a ctypes call into a library built by ``ops/_build.py``
(``lib_name``, e.g. ``"field_bwd"``):

- :func:`row_op`: one layer over every row,
  ``v = sum_j A_j @ W_j [+ add] [+ bias]`` then one epilogue (``FWD_*`` for
  the recompute, ``BWD_*`` for the reverse sweep), written to workspaces in
  f32 and/or the compute dtype;
- :func:`reduce_op`: a batch of weight gradients ``A^T B`` and bias
  gradients ``sum_n B[n]`` in one launch, deterministic (each block walks
  every row in a fixed order, no atomics).

The wrappers of K2 (``ops/field_fused.py``) and K4 (``ops/trunk.py``) chain
them; these helpers only check shapes and fill the argument structs.
"""

from __future__ import annotations

import ctypes

import torch

from satnerf_torch.ops._build import check_launch, load_library

MAX_PRODS = 4
MAX_K = 512
MAX_JOBS = 24

# row_op epilogues (csrc/bwd_common.cuh RowMode)
FWD_LINEAR, FWD_SINE, FWD_RELU, BWD_SINE, BWD_RELU, PLAIN = range(6)

_vp, _i = ctypes.c_void_p, ctypes.c_int


class _RowArgs(ctypes.Structure):
    """Mirror of ``struct RowArgs`` in csrc/bwd_common.cuh."""

    _fields_ = [
        ("a", _vp * MAX_PRODS), ("w", _vp * MAX_PRODS), ("add", _vp),
        ("bias", _vp), ("pre", _vp), ("out_f32", _vp), ("out_dt", _vp),
        ("out2_dt", _vp), ("lda", _i * MAX_PRODS), ("k", _i * MAX_PRODS),
    ] + [(name, _i) for name in (
        "n_prod", "ld_add", "add_f32", "ld_pre", "pre_f32", "ld_out_f32",
        "ld_out_dt", "ld_out2", "rows", "width", "mode", "sin_mode", "bf16",
    )] + [("scale", ctypes.c_float)]


class _GemmJob(ctypes.Structure):
    _fields_ = [("a", _vp), ("b", _vp), ("out", _vp), ("lda", _i), ("ldb", _i),
                ("k", _i), ("m", _i)]


class _SumJob(ctypes.Structure):
    _fields_ = [("b", _vp), ("out", _vp), ("ldb", _i), ("m", _i), ("b_f32", _i)]


class _ReduceArgs(ctypes.Structure):
    """Mirror of ``struct ReduceArgs`` in csrc/bwd_common.cuh."""

    _fields_ = [("gemms", _GemmJob * MAX_JOBS), ("sums", _SumJob * MAX_JOBS),
                ("n_gemm", _i), ("n_sum", _i), ("rows", _i), ("bf16", _i)]


def _rows2d(t: torch.Tensor, rows: int, cols: int, name: str, dtypes) -> int:
    """Check a (rows, cols) view with unit column stride; its row stride."""
    if t.dim() != 2 or tuple(t.shape) != (rows, cols) or t.stride(1) != 1:
        raise ValueError(f"{name}: {tuple(t.shape)} strides {t.stride()}, "
                         f"expected ({rows}, {cols}) with unit column stride")
    if t.dtype not in dtypes or t.device.type != "cuda":
        raise ValueError(f"{name}: {t.dtype} on {t.device}")
    return t.stride(0)


def row_op(lib_name: str, fn_name: str, dt: torch.dtype, rows: int, width: int, prods=(),
           add=None, bias=None, pre=None, mode: int = PLAIN, scale: float = 1.0,
           sin_mode: int = 0, out_f32=None, out_dt=None, out2_dt=None) -> None:
    """One launch of the row kernel; ``prods`` is a list of (A, W) pairs."""
    if len(prods) > MAX_PRODS:
        raise ValueError(f"row_op: {len(prods)} products, at most {MAX_PRODS}")
    f32 = torch.float32
    args = _RowArgs()
    for j, (a, w) in enumerate(prods):
        k = a.shape[1]
        if k % 4 or k > MAX_K:
            raise ValueError(f"row_op: K={k} must be a multiple of 4, <= {MAX_K}")
        args.lda[j] = _rows2d(a, rows, k, f"A[{j}]", (dt,))
        _rows2d(w, k, width, f"W[{j}]", (dt,))
        if not w.is_contiguous():
            raise ValueError(f"row_op: W[{j}] must be contiguous")
        args.a[j], args.w[j], args.k[j] = a.data_ptr(), w.data_ptr(), k
    args.n_prod = len(prods)
    if add is not None:
        args.ld_add = _rows2d(add, rows, width, "add", (dt, f32))
        args.add, args.add_f32 = add.data_ptr(), int(add.dtype == f32)
    if bias is not None:
        if bias.shape != (width,) or bias.dtype != f32 or not bias.is_contiguous():
            raise ValueError(f"row_op: bias {tuple(bias.shape)} {bias.dtype}")
        args.bias = bias.data_ptr()
    if pre is not None:
        args.ld_pre = _rows2d(pre, rows, width, "pre", (dt, f32))
        args.pre, args.pre_f32 = pre.data_ptr(), int(pre.dtype == f32)
    for name, t, dts in (("out_f32", out_f32, (f32,)), ("out_dt", out_dt, (dt,)),
                         ("out2_dt", out2_dt, (dt,))):
        if t is not None:
            ld = _rows2d(t, rows, width, name, dts)
            setattr(args, name, t.data_ptr())
            setattr(args, "ld_out2" if name == "out2_dt" else f"ld_{name}", ld)
    args.rows, args.width, args.mode = rows, width, mode
    args.sin_mode, args.bf16, args.scale = sin_mode, int(dt == torch.bfloat16), scale
    lib = load_library(lib_name)
    stream = torch.cuda.current_stream().cuda_stream
    check_launch(lib, getattr(lib, fn_name)(ctypes.byref(args), ctypes.c_void_p(stream)),
                 fn_name)


def reduce_op(lib_name: str, fn_name: str, dt: torch.dtype, rows: int, gemms=(), sums=()) -> None:
    """One launch of the reduction kernel.

    ``gemms``: (A (rows, k), B (rows, m), out (k, m) contiguous f32) triples,
    out = A^T B; ``sums``: (B (rows, m), out (m,) f32) pairs, out = sum_n B[n].
    """
    if len(gemms) > MAX_JOBS or len(sums) > MAX_JOBS:
        raise ValueError(f"reduce_op: {len(gemms)} + {len(sums)} jobs, "
                         f"at most {MAX_JOBS} of each")
    f32 = torch.float32
    args = _ReduceArgs()
    for j, (a, b, out) in enumerate(gemms):
        k, m = a.shape[1], b.shape[1]
        job = args.gemms[j]
        job.lda = _rows2d(a, rows, k, f"gemm[{j}].A", (dt,))
        job.ldb = _rows2d(b, rows, m, f"gemm[{j}].B", (dt,))
        if tuple(out.shape) != (k, m) or out.dtype != f32 or not out.is_contiguous():
            raise ValueError(f"reduce_op: gemm[{j}] out {tuple(out.shape)} {out.dtype}")
        job.a, job.b, job.out, job.k, job.m = (a.data_ptr(), b.data_ptr(),
                                               out.data_ptr(), k, m)
    for j, (b, out) in enumerate(sums):
        m = b.shape[1]
        job = args.sums[j]
        job.ldb = _rows2d(b, rows, m, f"sum[{j}].B", (dt, f32))
        if tuple(out.shape) != (m,) or out.dtype != f32 or not out.is_contiguous():
            raise ValueError(f"reduce_op: sum[{j}] out {tuple(out.shape)} {out.dtype}")
        job.b, job.out, job.m, job.b_f32 = (b.data_ptr(), out.data_ptr(), m,
                                            int(b.dtype == f32))
    args.n_gemm, args.n_sum, args.rows = len(gemms), len(sums), rows
    args.bf16 = int(dt == torch.bfloat16)
    lib = load_library(lib_name)
    stream = torch.cuda.current_stream().cuda_stream
    check_launch(lib, getattr(lib, fn_name)(ctypes.byref(args), ctypes.c_void_p(stream)),
                 fn_name)


def width_for(n: int, widths) -> int:
    """The smallest instantiated output width that holds ``n`` columns."""
    for w in sorted(widths):
        if n <= w:
            return w
    raise ValueError(f"{n} columns exceed the kernel's widths {tuple(widths)}")

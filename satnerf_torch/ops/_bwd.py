"""Launch helpers of the backward kernels K2 and K4 (``csrc/bwd_common.cuh``).

Two primitives, each a ctypes call into a library built by ``ops/_build.py``
(``lib_name``, e.g. ``"field_bwd"``):

- :func:`row_op`: one layer over every row,
  ``v = sum_j A_j @ W_j [+ add] [+ bias]`` then one epilogue (``FWD_*`` for
  the recompute, ``BWD_*`` for the reverse sweep), written to workspaces in
  f32 and/or the compute dtype. Each product is given as ``(A, Wt)`` with
  ``Wt = W^T`` stored (width, K), K-major as the tensor cores take it; in
  f32 ``Wt`` may come with its 3xTF32 split (:func:`tf32_split`), which a
  wrapper makes once per backward for a weight it uses often.
- :func:`reduce_op`: a batch of weight gradients ``A^T B`` and bias
  gradients ``sum_n B[n]``, deterministic: the kernel sums fixed chunks of
  ``SPLIT_ROWS`` rows and a second launch adds the chunks in order. In f32 a
  bias sum whose rows are some GEMM's B is folded into that GEMM's pass.

The wrappers of K2 (``ops/field_fused.py``) and K4 (``ops/trunk.py``) chain
them; these helpers check shapes, pad K where a row is not a whole number of
16-byte pieces, split f32 weights, allocate the partial sums and fill the
argument structs.

:func:`matmul_3xtf32` is the plain PyTorch emulation of the f32 products:
tf32 rounding (:func:`tf32_round`, the kernels' ``tc::tf32_rna``), the
hi/lo split, and ``lo*hi + hi*lo + hi*hi``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from satnerf_torch.ops._build import check_launch, load_library

MAX_PRODS = 4
MAX_K = 1024  # K of a tensor-core product (csrc/bwd_common.cuh kMaxK)
THIN_MAX_K = 512  # K of a product on the 16-wide FMA route (kThinMaxK)
MAX_JOBS = 24
THIN_WIDTH = 16  # the output width that stays on the FMA row kernel
SPLIT_ROWS = 8192  # rows per partial sum of the reduction

# row_op epilogues (csrc/bwd_common.cuh RowMode)
FWD_LINEAR, FWD_SINE, FWD_RELU, BWD_SINE, BWD_RELU, PLAIN = range(6)

_vp, _i = ctypes.c_void_p, ctypes.c_int


# -- 3xTF32 ------------------------------------------------------------------------


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest tf32 (ties away from zero), as an f32 whose low 13
    mantissa bits are 0: ``(bits + 0x1000) & ~0x1FFF``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """x ~ hi + lo with hi = tf32(x), lo = tf32(x - hi)."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


class Tf32Split(NamedTuple):
    """An f32 weight ``w`` beside its split ``(hi, lo)``, made once by a
    wrapper that passes the weight to several launches."""

    w: torch.Tensor
    hi: torch.Tensor
    lo: torch.Tensor


def tf32_split(w: torch.Tensor) -> Tf32Split:
    return Tf32Split(w, *split_tf32(w))


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the f32 kernels compute it: each operand split into tf32
    hi + lo, then lo*hi + hi*lo + hi*hi (lo*lo, ~2^-22 of the product, is
    dropped). Each term is exact in f32; the sums are f32."""
    ah, al = split_tf32(a.float())
    bh, bl = split_tf32(b.float())
    return al @ bh + ah @ bl + ah @ bh


# -- argument structs ----------------------------------------------------------------


class _RowArgs(ctypes.Structure):
    """Mirror of ``struct RowArgs`` in csrc/bwd_common.cuh."""

    _fields_ = [
        ("a", _vp * MAX_PRODS), ("w", _vp * MAX_PRODS), ("w_lo", _vp * MAX_PRODS),
        ("add", _vp), ("bias", _vp), ("pre", _vp), ("out_f32", _vp), ("out_dt", _vp),
        ("out2_dt", _vp), ("lda", _i * MAX_PRODS), ("k", _i * MAX_PRODS),
    ] + [(name, _i) for name in (
        "n_prod", "ld_add", "add_f32", "ld_pre", "pre_f32", "ld_out_f32",
        "ld_out_dt", "ld_out2", "rows", "width", "mode", "sin_mode", "bf16",
    )] + [("scale", ctypes.c_float)]


class _GemmJob(ctypes.Structure):
    _fields_ = [("a", _vp), ("b", _vp), ("part", _vp), ("out", _vp), ("bias_part", _vp),
                ("bias_out", _vp), ("lda", _i), ("ldb", _i), ("k", _i), ("m", _i)]


class _SumJob(ctypes.Structure):
    _fields_ = [("b", _vp), ("out", _vp), ("ldb", _i), ("m", _i), ("b_f32", _i)]


class _ReduceArgs(ctypes.Structure):
    """Mirror of ``struct ReduceArgs`` in csrc/bwd_common.cuh."""

    _fields_ = [("gemms", _GemmJob * MAX_JOBS), ("sums", _SumJob * MAX_JOBS)] + [
        (name, _i) for name in ("n_gemm", "n_sum", "rows", "bf16", "split_rows", "n_split")]


def _rows2d(t: torch.Tensor, rows: int, cols: int, name: str, dtypes) -> int:
    """Check a (rows, cols) view with unit column stride; its row stride."""
    if t.dim() != 2 or tuple(t.shape) != (rows, cols) or t.stride(1) != 1:
        raise ValueError(f"{name}: {tuple(t.shape)} strides {t.stride()}, "
                         f"expected ({rows}, {cols}) with unit column stride")
    if t.dtype not in dtypes or t.device.type != "cuda":
        raise ValueError(f"{name}: {t.dtype} on {t.device}")
    return t.stride(0)


# -- layouts -------------------------------------------------------------------------


def pad_cols(t: torch.Tensor, cols: int) -> torch.Tensor:
    """``t`` with zero columns appended up to ``cols`` (``t`` itself if none)."""
    if t.shape[-1] == cols:
        return t
    return torch.nn.functional.pad(t, (0, cols - t.shape[-1])).contiguous()


def padded_k(k: int) -> int:
    """K rounded up to a multiple of 16, which every staging route takes."""
    return -(-k // 16) * 16


def _aligned(t: torch.Tensor) -> bool:
    """Rows of ``t`` are whole 16-byte pieces starting on 16-byte addresses."""
    per = 16 // t.element_size()
    return t.shape[1] % per == 0 and t.stride(0) % per == 0 and t.data_ptr() % 16 == 0


def _weight_parts(wt, dt: torch.dtype):
    """(hi, lo) tensors of a product's ``Wt``: in f32 its tf32 split (made here
    unless given), in bf16 the tensor and None."""
    if isinstance(wt, Tf32Split):
        if dt != torch.float32:
            raise ValueError("row_op: a split weight is f32 only")
        return wt.hi, wt.lo
    if dt == torch.float32:
        return split_tf32(wt)
    return wt, None


def row_op(lib_name: str, fn_name: str, dt: torch.dtype, rows: int, width: int, prods=(),
           add=None, bias=None, pre=None, mode: int = PLAIN, scale: float = 1.0,
           sin_mode: int = 0, out_f32=None, out_dt=None, out2_dt=None) -> None:
    """One launch of the row GEMM; ``prods`` is a list of (A (rows, K),
    Wt (width, K) or its :class:`Tf32Split`) pairs."""
    if len(prods) > MAX_PRODS:
        raise ValueError(f"row_op: {len(prods)} products, at most {MAX_PRODS}")
    f32 = torch.float32
    thin = width == THIN_WIDTH
    args = _RowArgs()
    keep = []  # temporaries that must outlive the launch call
    for j, (a, wt) in enumerate(prods):
        k = a.shape[1]
        if thin:
            if isinstance(wt, Tf32Split):
                raise ValueError("row_op: the 16-wide route takes the weight unsplit")
            if k % 4 or k > THIN_MAX_K:
                raise ValueError(f"row_op: K={k} must be a multiple of 4, <= {THIN_MAX_K}")
            hi, lo = wt.t().contiguous(), None  # the FMA kernel reads W (K, width)
            _rows2d(hi, k, width, f"W[{j}]", (dt,))
        else:
            hi, lo = _weight_parts(wt, dt)
            if not _aligned(a):  # pad K with zeros to a multiple of 16
                kp = padded_k(k)
                a = pad_cols(a, kp)
                hi = pad_cols(hi, kp)
                lo = pad_cols(lo, kp) if lo is not None else None
                k = kp
            if k > MAX_K:
                raise ValueError(f"row_op: K={k} > {MAX_K}")
            for t, nm in ((hi, "Wt"), (lo, "Wt_lo")):
                if t is not None:
                    _rows2d(t, width, k, f"{nm}[{j}]", (dt,))
                    if not t.is_contiguous():
                        raise ValueError(f"row_op: {nm}[{j}] must be contiguous")
        args.lda[j] = _rows2d(a, rows, k, f"A[{j}]", (dt,))
        args.a[j], args.w[j], args.k[j] = a.data_ptr(), hi.data_ptr(), k
        args.w_lo[j] = lo.data_ptr() if lo is not None else None
        keep += [a, hi, lo]
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
    del keep


def n_splits(rows: int) -> int:
    """Chunks of ``SPLIT_ROWS`` rows the reduction sums apart (at least 1)."""
    return max(1, -(-rows // SPLIT_ROWS))


def fold_sums(dt: torch.dtype, gemms, sums):
    """({gemm index: the out of the bias sum folded into it}, the sums left):
    in f32 a sum whose rows are the very tensor some GEMM stages as its B
    rides along with that GEMM (the first one)."""
    folded, rest = {}, []
    for b, out in sums:
        j = next((j for j, (_, gb, _) in enumerate(gemms)
                  if dt == torch.float32 and j not in folded and gb.dtype == b.dtype
                  and gb.data_ptr() == b.data_ptr() and gb.shape == b.shape
                  and gb.stride() == b.stride()), None)
        if j is None:
            rest.append((b, out))
        else:
            folded[j] = out
    return folded, rest


def reduce_op(lib_name: str, fn_name: str, dt: torch.dtype, rows: int, gemms=(), sums=()) -> None:
    """One reduction: two launches, the chunked tiles and the ordered sum.

    ``gemms``: (A (rows, k), B (rows, m), out (k, m) contiguous f32) triples,
    out = A^T B; ``sums``: (B (rows, m), out (m,) f32) pairs, out = sum_n B[n].
    """
    if len(gemms) > MAX_JOBS or len(sums) > MAX_JOBS:
        raise ValueError(f"reduce_op: {len(gemms)} + {len(sums)} jobs, "
                         f"at most {MAX_JOBS} of each")
    f32 = torch.float32
    folded, rest = fold_sums(dt, gemms, sums)
    n_split = n_splits(rows)
    args = _ReduceArgs()
    keep = []
    for j, (a, b, out) in enumerate(gemms):
        k, m = a.shape[1], b.shape[1]
        job = args.gemms[j]
        job.lda = _rows2d(a, rows, k, f"gemm[{j}].A", (dt,))
        job.ldb = _rows2d(b, rows, m, f"gemm[{j}].B", (dt,))
        if tuple(out.shape) != (k, m) or out.dtype != f32 or not out.is_contiguous():
            raise ValueError(f"reduce_op: gemm[{j}] out {tuple(out.shape)} {out.dtype}")
        part = torch.empty((n_split, k, m), dtype=f32, device=out.device)
        job.a, job.b, job.part, job.out, job.k, job.m = (
            a.data_ptr(), b.data_ptr(), part.data_ptr(), out.data_ptr(), k, m)
        keep.append(part)
        if j in folded:
            bout = folded[j]
            if tuple(bout.shape) != (m,) or bout.dtype != f32 or not bout.is_contiguous():
                raise ValueError(f"reduce_op: sum out {tuple(bout.shape)} {bout.dtype}")
            bpart = torch.empty((n_split, m), dtype=f32, device=out.device)
            job.bias_part, job.bias_out = bpart.data_ptr(), bout.data_ptr()
            keep.append(bpart)
    for j, (b, out) in enumerate(rest):
        m = b.shape[1]
        job = args.sums[j]
        job.ldb = _rows2d(b, rows, m, f"sum[{j}].B", (dt, f32))
        if tuple(out.shape) != (m,) or out.dtype != f32 or not out.is_contiguous():
            raise ValueError(f"reduce_op: sum[{j}] out {tuple(out.shape)} {out.dtype}")
        job.b, job.out, job.m, job.b_f32 = (b.data_ptr(), out.data_ptr(), m,
                                            int(b.dtype == f32))
    args.n_gemm, args.n_sum, args.rows = len(gemms), len(rest), rows
    args.bf16 = int(dt == torch.bfloat16)
    args.split_rows, args.n_split = SPLIT_ROWS, n_split
    lib = load_library(lib_name)
    stream = torch.cuda.current_stream().cuda_stream
    check_launch(lib, getattr(lib, fn_name)(ctypes.byref(args), ctypes.c_void_p(stream)),
                 fn_name)
    del keep


def width_for(n: int, widths) -> int:
    """The smallest instantiated output width that holds ``n`` columns."""
    for w in sorted(widths):
        if n <= w:
            return w
    raise ValueError(f"{n} columns exceed the kernel's widths {tuple(widths)}")

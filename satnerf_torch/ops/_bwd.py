"""Launch helpers of the backward kernels K2 and K4 (``csrc/bwd_common.cuh``).

Two primitives, each a ctypes call into a library built by ``ops/_build.py``
(``lib_name``, e.g. ``"field_bwd"``):

- :func:`row_op`: one layer over every row,
  ``v = sum_j A_j @ W_j [+ add] [+ bias]`` then one epilogue (``FWD_*`` for
  the recompute, ``BWD_*`` for the reverse sweep), written to workspaces in
  f32 and/or the compute dtype. Each product is given as ``(A, Wt)`` with
  ``Wt = W^T`` stored (width, K), or as ``(A, RowWeight)``: the same weight
  with its tiles prepared by :func:`row_weight` (the kernel's bulk copies
  read B from them), which a wrapper makes once per backward for a weight
  it uses often; a plain ``Wt`` is prepared at each launch.
- :func:`reduce_op`: a batch of weight gradients ``A^T B`` and bias
  gradients ``sum_n B[n]``, deterministic: the kernel sums fixed chunks of
  ``SPLIT_ROWS`` rows (weight and bias gradients alike) and a second launch
  adds the chunks in order. In f32 a bias sum whose rows are some GEMM's B
  is folded into that GEMM's pass.

The wrappers of K2 (``ops/field_fused.py``) and K4 (``ops/trunk.py``) chain
them; these helpers check shapes, pad K where a row is not a whole number of
16-byte pieces, prepare the weights' tiles, allocate the partial sums and
fill the argument structs.

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
SPLIT_ROWS = 8192  # rows per partial sum of the reduction (kSplitRows)
CHUNK_BYTES = 128  # K of one staged chunk: 32 f32 or 64 bf16 values (Tc::kKc)
ROW_STAGES = 4  # the row GEMM's ring (kRowStages)

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


def row_bn(width: int, dt: torch.dtype) -> int:
    """Columns of the row GEMM's tiles at this output width (the fixed rule
    on shape of csrc/bwd_common.cuh ``row_bn``): the widest of 256 (bf16
    only), 128 and 64 that divides it."""
    if width <= 0 or width % 64:
        raise ValueError(f"row GEMM width {width}: a multiple of 64 (or {THIN_WIDTH})")
    if dt == torch.bfloat16 and width % 256 == 0:
        return 256
    return 128 if width % 128 == 0 else 64


def swizzle_tiles(w: torch.Tensor, bn: int) -> torch.Tensor:
    """W^T (width, K) -> its tiles as the row GEMM's bulk copies read them:
    (width / bn, chunks, bn, 8, 16 / element size), chunk c holding K columns
    [c kc, c kc + kc) (kc: 128 bytes of values, zeros past K) of bn rows, each
    row's 16-byte pieces swizzled (piece p at position p ^ (row % 8), the
    layout of ``tc::sw128``)."""
    width, k = w.shape
    esz = w.element_size()
    kc, per = CHUNK_BYTES // esz, 16 // esz
    nkc = -(-k // kc)
    t = pad_cols(w.contiguous(), nkc * kc).reshape(width // bn, bn, nkc, 8, per)
    t = t.permute(0, 2, 1, 3, 4)
    rows = torch.arange(bn, device=w.device)[:, None]
    idx = torch.arange(8, device=w.device)[None, :] ^ (rows % 8)  # position p <- piece p ^ (r % 8)
    return torch.gather(t, 3, idx[None, None, :, :, None].expand(t.shape)).contiguous()


class RowWeight(NamedTuple):
    """A product's ``Wt`` (width, K) beside its prepared tiles
    (:func:`row_weight`), made once by a wrapper that passes the weight to
    several launches."""

    w: torch.Tensor
    tiles: torch.Tensor
    bn: int


_PREP = {"trunk_bwd": "trunk_bwd_prep", "field_bwd": "heads_bwd_prep"}


def row_weight(wt: torch.Tensor, dt: torch.dtype, lib_name: str = "trunk_bwd") -> RowWeight:
    """``Wt`` (width, K) in the compute dtype -> its :class:`RowWeight`: the
    tiles of :func:`swizzle_tiles` at the width's :func:`row_bn`, in f32 the
    tf32 hi part's then the lo part's chunk by chunk
    ((width / bn, chunks, 2, bn, 8, 4)), in bf16 the weight's
    ((width / bn, chunks, 1, bn, 8, 8)). A CUDA weight is prepared by one
    launch of ``csrc/bwd_common.cuh``'s prep_kernel (from ``lib_name``); a
    CPU one by that construction in torch, the kernel's plain version."""
    if wt.dtype != dt:
        raise ValueError(f"row_weight: {wt.dtype} weight for a {dt} launch")
    bn = row_bn(wt.shape[0], dt)
    if wt.device.type == "cpu":
        parts = split_tf32(wt) if dt == torch.float32 else (wt,)
        return RowWeight(wt, torch.stack([swizzle_tiles(p, bn) for p in parts], dim=2), bn)
    width, k = wt.shape
    ld = _rows2d(wt, width, k, "Wt", (dt,))
    esz = wt.element_size()
    parts = 2 if dt == torch.float32 else 1
    tiles = torch.empty((width // bn, -(-k * esz // CHUNK_BYTES), parts, bn, 8, 16 // esz),
                        dtype=dt, device=wt.device)
    lib = load_library(lib_name)
    fn = _PREP[lib_name]
    stream = torch.cuda.current_stream().cuda_stream
    check_launch(lib, getattr(lib, fn)(wt.data_ptr(), ld, width, k, bn, int(parts == 1),
                                       tiles.data_ptr(), ctypes.c_void_p(stream)), fn)
    return RowWeight(wt, tiles, bn)


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
        ("a", _vp * MAX_PRODS), ("w", _vp * MAX_PRODS),
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
    _fields_ = [("b", _vp), ("out", _vp), ("part", _vp), ("ldb", _i), ("m", _i), ("b_f32", _i)]


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


def row_op(lib_name: str, fn_name: str, dt: torch.dtype, rows: int, width: int, prods=(),
           add=None, bias=None, pre=None, mode: int = PLAIN, scale: float = 1.0,
           sin_mode: int = 0, out_f32=None, out_dt=None, out2_dt=None) -> None:
    """One launch of the row GEMM; ``prods`` is a list of (A (rows, K),
    Wt (width, K) or its :class:`RowWeight`) pairs."""
    if len(prods) > MAX_PRODS:
        raise ValueError(f"row_op: {len(prods)} products, at most {MAX_PRODS}")
    f32 = torch.float32
    thin = width == THIN_WIDTH
    args = _RowArgs()
    keep = []  # temporaries that must outlive the launch call
    for j, (a, wt) in enumerate(prods):
        k = a.shape[1]
        if thin:
            if isinstance(wt, RowWeight):
                raise ValueError("row_op: the 16-wide route takes the weight unprepared")
            if k % 4 or k > THIN_MAX_K:
                raise ValueError(f"row_op: K={k} must be a multiple of 4, <= {THIN_MAX_K}")
            w = wt.t().contiguous()  # the FMA kernel reads W (K, width)
            _rows2d(w, k, width, f"W[{j}]", (dt,))
        else:
            rw = wt if isinstance(wt, RowWeight) else row_weight(wt, dt, lib_name)
            _rows2d(rw.w, width, k, f"Wt[{j}]", (dt,))
            if rw.bn != row_bn(width, dt) or not rw.tiles.is_contiguous():
                raise ValueError(f"row_op: Wt[{j}]'s tiles are not this width's")
            if not _aligned(a):  # pad K with zeros to a multiple of 16
                k = padded_k(k)
                a = pad_cols(a, k)
            if k > MAX_K:
                raise ValueError(f"row_op: K={k} > {MAX_K}")
            w = rw.tiles
        args.lda[j] = _rows2d(a, rows, k, f"A[{j}]", (dt,))
        args.a[j], args.w[j], args.k[j] = a.data_ptr(), w.data_ptr(), k
        keep += [a, w]
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
        part = torch.empty((n_split, m), dtype=f32, device=out.device)
        job.b, job.out, job.part, job.m, job.b_f32 = (b.data_ptr(), out.data_ptr(),
                                                      part.data_ptr(), m, int(b.dtype == f32))
        keep.append(part)
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

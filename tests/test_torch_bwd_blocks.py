"""The launch helpers of K2's and K4's two building blocks
(satnerf_torch/ops/_bwd.py) against csrc/bwd_common.cuh, read from the
source: the constants and ctypes argument structs the helpers mirror, the
row GEMM's epilogue numbering, the fixed rule on shape that picks the row
GEMM's tile columns, and the prepared weight tiles (``row_weight``) that
the row GEMM's bulk copies read, against a construction written out from
their definition. On the CPU, in seconds."""

import os
import re

import numpy as np
import pytest
import torch

from satnerf_torch.ops import _bwd
from torch_parity import _emulated_row_op


def _csrc(name: str) -> str:
    with open(os.path.join(os.path.dirname(_bwd.__file__), os.pardir, "csrc", name)) as f:
        return f.read()


SRC = _csrc("bwd_common.cuh")


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


@pytest.mark.parametrize("name,value", [
    ("kMaxProds", _bwd.MAX_PRODS), ("kMaxK", _bwd.MAX_K), ("kThinMaxK", _bwd.THIN_MAX_K),
    ("kMaxJobs", _bwd.MAX_JOBS), ("kThinWidth", _bwd.THIN_WIDTH),
    ("kSplitRows", _bwd.SPLIT_ROWS), ("kRowStages", _bwd.ROW_STAGES),
])
def test_constants_mirror_the_source(name, value):
    assert _constant(name) == value


def test_chunks_are_128_bytes_of_values_in_both_dtypes():
    """Tc<T>::kKc values of each dtype make one 128-byte chunk, the K of
    every staged tile and of the prepared weight tiles."""
    found = re.findall(r"template <> struct Tc<(float|__nv_bfloat16)> \{\s*"
                       r"static constexpr int kKc = (\d+), kParts = (\d+);", SRC)
    got = {t: int(kc) * (4 if t == "float" else 2) for t, kc, _ in found}
    assert got == {"float": _bwd.CHUNK_BYTES, "__nv_bfloat16": _bwd.CHUNK_BYTES}
    assert "static constexpr int kStages = kRowStages;" in SRC


def _struct_fields(name: str) -> list:
    """[(field, kind, array length or None)] of ``struct name`` in the
    source, in order; kind "ptr", "int", "float" or a struct's name."""
    body = re.search(rf"\nstruct {name} \{{\n(.*?)\n\}};", SRC, re.S).group(1)
    out = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip()
        if not decl:
            continue
        m = re.fullmatch(r"(?:const\s+)?(void|float|int|GemmJob|SumJob)\s*(\*?)\s*(.+);", decl)
        assert m, decl
        kind = "ptr" if m.group(2) else m.group(1)
        for item in m.group(3).split(","):
            arr = re.fullmatch(r"(\w+)\[(\w+)\]", item.strip())
            if arr:
                out.append((arr.group(1), kind, _constant(arr.group(2))))
            else:
                out.append((item.strip(), kind, None))
    return out


def _ctypes_fields(cls) -> list:
    out = []
    for field, typ in cls._fields_:
        length = getattr(typ, "_length_", None)
        base = typ._type_ if length is not None else typ
        kind = {torch_c: k for torch_c, k in (
            (_bwd.ctypes.c_void_p, "ptr"), (_bwd.ctypes.c_int, "int"),
            (_bwd.ctypes.c_float, "float"))}.get(base, getattr(base, "__name__", "")
                                                 .lstrip("_"))
        out.append((field, kind, length))
    return out


@pytest.mark.parametrize("name,cls", [
    ("RowArgs", _bwd._RowArgs), ("GemmJob", _bwd._GemmJob), ("SumJob", _bwd._SumJob),
    ("ReduceArgs", _bwd._ReduceArgs),
])
def test_argument_structs_mirror_the_source(name, cls):
    """Field names, order, kinds and array lengths of the ctypes mirrors."""
    assert _ctypes_fields(cls) == _struct_fields(name)


def test_row_modes_mirror_the_source():
    body = re.search(r"enum RowMode : int \{(.*?)\};", SRC, re.S).group(1)
    modes = {m: int(v) for m, v in re.findall(r"(k\w+) = (\d+),", body)}
    assert modes == {"kFwdLinear": _bwd.FWD_LINEAR, "kFwdSine": _bwd.FWD_SINE,
                     "kFwdRelu": _bwd.FWD_RELU, "kBwdSine": _bwd.BWD_SINE,
                     "kBwdRelu": _bwd.BWD_RELU, "kPlain": _bwd.PLAIN}


def _ternary(expr: str, width: int) -> int:
    """Evaluate the source's chain ``c ? v : c ? v : v`` (C's && as and)."""
    if "?" not in expr:
        return int(eval(expr, {}, {"width": width}))
    cond, rest = expr.split("?", 1)
    value, other = rest.split(":", 1)
    if eval(cond.replace("&&", " and "), {}, {"width": width}):
        return int(value)
    return _ternary(other, width)


@pytest.mark.parametrize("width", [64, 128, 192, 256, 320, 384, 448, 512, 640, 768, 896, 1024])
def test_row_tile_columns_follow_the_source_rule(width):
    """ops/_bwd.py:row_bn is csrc/bwd_common.cuh's row_bn, for both dtypes
    at every width a wrapper launches."""
    rule = re.search(r"constexpr int row_bn\(int width\) \{\s*return (.*?);\n", SRC, re.S)
    for dt, parts in ((torch.float32, 2), (torch.bfloat16, 1)):
        expr = " ".join(rule.group(1).split()).replace("Tc<T>::kParts", str(parts))
        assert _bwd.row_bn(width, dt) == _ternary(expr, width)


def test_row_tile_columns_refuse_other_widths():
    for width in (0, 16, 96, 200):
        with pytest.raises(ValueError):
            _bwd.row_bn(width, torch.float32)


def _direct_tiles(w: torch.Tensor, bn: int) -> np.ndarray:
    """W^T's tiles from their definition, as raw bits: column block b, chunk
    c: rows b bn .. b bn + bn - 1, K columns c kc .. c kc + kc - 1 (zeros
    past K); in each 128-byte row the 16-byte piece p stored at position
    p ^ (row % 8)."""
    bits = w.contiguous().view(torch.int32 if w.element_size() == 4 else torch.int16).numpy()
    width, k = bits.shape
    kc, per = _bwd.CHUNK_BYTES // w.element_size(), 16 // w.element_size()
    nkc = -(-k // kc)
    out = np.zeros((width // bn, nkc, bn, kc), dtype=bits.dtype)
    cols = np.arange(kc)
    for b in range(width // bn):
        for c in range(nkc):
            for r in range(bn):
                kk = c * kc + cols
                ok = kk < k
                pos = ((cols // per) ^ (r % 8)) * per + cols % per
                out[b, c, r, pos[ok]] = bits[b * bn + r, kk[ok]]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width,k", [(64, 16), (128, 60), (192, 72), (256, 512), (384, 128),
                                     (512, 1024), (1024, 40)])
def test_row_weight_tiles_match_their_definition(dtype, width, k):
    """row_weight's tiles, bit for bit: (width / bn, chunks, parts, bn, 8,
    pieces), contiguous, so that chunk (b, c) starts (b chunks + c) x parts
    x bn x 128 bytes in, as the producer's bulk copy reads it; f32 parts
    the tf32 hi and lo of ops/_bwd.py:split_tf32."""
    g = torch.Generator().manual_seed(width + k)
    wt = torch.randn(width, k, generator=g).to(dtype)
    rw = _bwd.row_weight(wt, dtype)
    bn = _bwd.row_bn(width, dtype)
    parts = _bwd.split_tf32(wt) if dtype == torch.float32 else (wt,)
    nkc = -(-k // (_bwd.CHUNK_BYTES // wt.element_size()))
    per = 16 // wt.element_size()
    assert rw.bn == bn and rw.w is wt and rw.tiles.is_contiguous()
    assert tuple(rw.tiles.shape) == (width // bn, nkc, len(parts), bn, 8, per)
    ints = torch.int32 if dtype == torch.float32 else torch.int16
    for i, part in enumerate(parts):
        got = rw.tiles[:, :, i].reshape(width // bn, nkc, bn, 8 * per).view(ints).numpy()
        assert np.array_equal(got, _direct_tiles(part, bn)), i


def test_row_weight_refuses_another_dtype():
    with pytest.raises(ValueError):
        _bwd.row_weight(torch.zeros(64, 16), torch.bfloat16)


def test_emulated_row_op_holds_a_prepared_weight_to_its_tiles():
    """The CPU emulation of the row GEMM takes a RowWeight as the kernel
    does, by the weight it was prepared from, and refuses tiles that are
    not that weight's."""
    g = torch.Generator().manual_seed(3)
    a, wt = torch.randn(40, 32, generator=g), torch.randn(128, 32, generator=g)
    out = torch.empty(40, 128)
    _emulated_row_op("trunk_bwd", "trunk_bwd_row", torch.float32, 40, 128,
                     prods=[(a, _bwd.row_weight(wt, torch.float32))], out_f32=out)
    assert torch.allclose(out, a @ wt.t(), rtol=1e-5, atol=1e-5)
    stale = _bwd.row_weight(wt, torch.float32)._replace(w=wt + 1.0)
    with pytest.raises(AssertionError):
        _emulated_row_op("trunk_bwd", "trunk_bwd_row", torch.float32, 40, 128,
                         prods=[(a, stale)], out_f32=out)

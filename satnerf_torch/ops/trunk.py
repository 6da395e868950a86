"""SIREN trunk: the trunk-only forward (K3, with its interleaved variant K6)
and the trunk backward (K4, both engines).

Port of ``satnerf_tpu/ops/pallas/trunk.py``: ``fused_trunk`` (body
``_fwd_kernel``, with the "stored" residuals of ``emit_acts``) and its custom
VJP ``_fused_trunk_bwd`` (bodies ``_bwd_kernel`` "recompute",
``_bwd_kernel_stored`` "stored" and the shared reverse sweep ``_bwd_sweep``),
and of the prototype ``tools/interleave_trunk_proto.py`` (``_fwd_kernel_il``).
:func:`fused_trunk` launches K3 of ``csrc/trunk_fwd.cu`` and
:func:`trunk_backward` the kernels of ``csrc/trunk_bwd.cu`` for CUDA tensors;
for CPU tensors they run their plain PyTorch versions
(:func:`fused_trunk_reference`, :func:`trunk_backward_reference`). Under
autograd :func:`fused_trunk` goes through :class:`FusedTrunk`: K3 forward,
K4 backward. K1 (``ops/field_fused.py``) runs the same trunk in front of its
heads; the CUDA trunk loop of both is ``csrc/trunk_tc.cuh`` (tensor cores),
which takes the weights prepared by :func:`tc_trunk_weights`.
:func:`fused_trunk_interleaved` (K6, off every path) runs the same
arithmetic on the warp-specialised ping-pong loop of ``csrc/trunk_ws.cuh``,
on the same prepared weights (in f32 split once into tf32 hi and lo by
:func:`tc_split_weights`), and equals K3 bit for bit.

The trunk is ``h_0 = sin(w0 * (x @ W0 + b0))``,
``h_i = sin(h_{i-1} @ W_i [+ x @ Ws_i] + b_i)``, on the packed layout of
:func:`pack_trunk` (``w0`` (cx, F), ``w_mid`` (L-1, F, F), ``w_skip``
(n_skip, cx, F), ``b`` (L, F) f32). Products take compute-dtype operands with
f32 sums, the sine runs in f32 and every activation is stored in the compute
dtype. Given the gradient of ``h_{L-1}`` the backward returns the gradients of
x and of every packed tensor. "recompute" rebuilds the pre-activations from
x; "stored" takes the (L, N, F) pre-activations that the forward kernel wrote.
As in the TPU kernel, every ``ga`` is cast to the compute dtype before its
products, the bias gradients sum the f32 ``ga``, and the weight gradients are
returned in the weights' dtype.

``spec`` is a ``FieldSpec`` of ``ops/field_fused.py`` (layers, feat, skips,
c_in, cx, w0, sin_mode, trunk_bwd).
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch.autograd.function import once_differentiable

from satnerf_torch.ops import _bwd
from satnerf_torch.ops._build import check_launch, load_library
from satnerf_torch.ops.fastmath import COSINE_ENGINES, SIN_MODES, SINE_ENGINES, acc_dtype

LAUNCHES = 0  # trunk_backward calls that launched K4 (CUDA only)
PLAIN_CALLS = 0  # trunk_backward_reference calls
FWD_LAUNCHES = 0  # K3 launches made by fused_trunk (CUDA tensors only)
FWD_PLAIN_CALLS = 0  # fused_trunk_reference calls
INTERLEAVED_LAUNCHES = 0  # K6 launches made by fused_trunk_interleaved
TC_PREPARATIONS = 0  # tc_gather calls: K1/K3 weight preparations (tc_cached misses)
# trunk widths K3 and K4 take: every multiple of 128 up to 1,024, as the TPU
# kernels (satnerf_tpu/ops/pallas/trunk.py:82) up to where their VMEM holds
# the weights; csrc/trunk_tc.cuh runs them as run-time widths of one kernel
# per dtype up to SMEM_MAX_FEAT and of a second one (H in global memory) past
# it
FEAT_WIDTHS = (128, 256, 384, 512, 640, 768, 896, 1024)
SMEM_MAX_FEAT = 512  # the widest trunk whose activations K1/K3 keep in shared memory
IL_FEAT_WIDTHS = (512,)  # K6's one width (csrc/trunk_fwd.cu kIlFeat)
GX_WIDTHS = (64, 128)  # padded input widths of the gx launch (csrc/trunk_bwd.cu)
TRUNK_KEYS = ("w0", "w_mid", "w_skip", "b")
# widest encoded input K1 and K3 take after padding to 16: every c_in the TPU
# kernels take (c_in <= 128, satnerf_tpu/ops/pallas/trunk.py:83), so every
# mapping_pos_n_freq up to 21 (csrc/trunk_tc.cuh kMaxX)
TC_MAX_K = 128
IL_MAX_K = 64  # K6's widest padded input (csrc/trunk_ws.cuh kMaxX)


def dot_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Product of compute-dtype operands summed in at least f32
    (``preferred_element_type=f32``): bf16 operands are upcast before the
    product, so it sums in f32; f64 operands stay f64."""
    acc = acc_dtype(torch.promote_types(a.dtype, w.dtype))
    return a.to(acc) @ w.to(acc)


# -----------------------------------------------------------------------
# packing
# -----------------------------------------------------------------------


def in_out(linear, dtype) -> torch.Tensor:
    """torch Linear weight (out, in) -> (in, out) in ``dtype``."""
    return linear.weight.t().to(dtype).contiguous()


def place_rows(w_in_out: torch.Tensor, rows: int, at: int) -> torch.Tensor:
    """``w_in_out`` placed at row ``at`` of a zero (rows, out) block."""
    out = w_in_out.new_zeros((rows, w_in_out.shape[1]))
    out[at : at + w_in_out.shape[0]] = w_in_out
    return out


def pack_trunk(field, spec, dtype: torch.dtype) -> dict:
    """The trunk of a ``models.field.Field`` in the kernels' packed layout:
    weights in ``dtype`` (the compute dtype), biases f32 (f64 for f64).
    Differentiable: under grad mode the packed tensors carry autograd history
    back to the module's parameters (``Field.packed`` caches a detached copy
    for inference)."""
    L, cx = spec.layers, spec.cx
    fc = [field.fc_net[2 * i] for i in range(L)]
    w0 = place_rows(in_out(fc[0], dtype), cx, 0)
    mids, skips = [], []
    for i in range(1, L):
        w = in_out(fc[i], dtype)
        if i in spec.skips:
            # reference concat order is [enc_x, h]
            skips.append(place_rows(w[: spec.c_in], cx, 0))
            mids.append(w[spec.c_in :])
        else:
            mids.append(w)
    return {
        "w0": w0,
        "w_mid": torch.stack(mids).contiguous(),
        "w_skip": (torch.stack(skips).contiguous() if skips
                   else w0.new_zeros((1, cx, spec.feat))),  # placeholder, never read
        "b": torch.stack([l.bias.to(acc_dtype(dtype)) for l in fc]).contiguous(),
    }


# -----------------------------------------------------------------------
# weights for the tensor-core forward kernels (K1, K3)
# -----------------------------------------------------------------------


TC_PASS_ROWS = 256  # output columns of one tensor-core pass (csrc/trunk_tc.cuh)
TC_TAIL_ROWS = 128  # the last pass of a width that is an odd multiple of 128


def tc_operand(wt: torch.Tensor, rows: int = TC_PASS_ROWS, ks: int | None = None) -> torch.Tensor:
    """A weight as the tensor-core forward takes it: ``wt`` = W^T (..., N, K),
    K padded with zeros to a multiple of 16, laid out as the kernels' shared
    memory tiles so that every chunk they stage is one contiguous copy:
    (..., N / rows, K / ks, rows, ks) for ks = 32 bytes of K (8 f32, 16
    bf16), each row's two 16-byte halves swapped where (row / 4) is odd (the
    32-byte swizzle of ``csrc/wgmma.cuh`` desc_sw32). A pass of ``rows``
    output columns and one k-step of it is a (rows, 32-byte) tile. Where N
    is not a multiple of ``rows`` (a 128- or 384-wide layer's last pass of
    :data:`TC_TAIL_ROWS`), the whole passes are followed by the last one in
    its own tiles, in the order the kernel stages them, and the result is
    flat: (..., N * K). (In f32 the kernels split the weights into tf32 hi +
    lo themselves.) ``ks`` overrides the element count per k-step (for an
    index tensor standing in for the weight, :func:`tc_gather`)."""
    wt = _bwd.pad_cols(wt, _bwd.padded_k(wt.shape[-1]))
    *lead, n, k = wt.shape
    ks = ks or 32 // wt.element_size()
    whole = n - n % rows
    if whole != n:
        if n - whole != TC_TAIL_ROWS:
            raise ValueError(f"tc_operand: {n} rows are not passes of {rows} and "
                             f"{TC_TAIL_ROWS}")
        parts = [tc_operand(wt[..., :whole, :], rows, ks)] if whole else []
        parts.append(tc_operand(wt[..., whole:, :], TC_TAIL_ROWS, ks))
        return torch.cat([t.reshape(*lead, -1) for t in parts], -1)
    x = wt.reshape(*lead, n // rows, rows, k // ks, 2, ks // 2)
    swap = ((torch.arange(rows, device=wt.device) >> 2) & 1).bool()
    x = torch.where(swap.view(rows, 1, 1, 1), x.flip(-2), x)
    return x.transpose(-4, -3).reshape(*lead, n // rows, k // ks, rows, ks).contiguous()


_TC_INDEX: dict = {}


def tc_gather(packed: dict, layouts: dict) -> dict:
    """The weights of ``packed`` named in ``layouts`` ({key: fn(t, ks)}, the
    layout of one weight for ``ks`` elements per k-step) rearranged by one
    gather: the layouts are applied once per shape set to an index tensor
    (1-based; 0, the padding, reads a zero) and cached, so each call costs a
    concatenation and one indexing kernel, not a chain of small ops per
    weight. Keys not in ``layouts`` pass through. Counted in
    ``TC_PREPARATIONS``."""
    global TC_PREPARATIONS
    TC_PREPARATIONS += 1
    keys = sorted(layouts)
    ws = [packed[k] for k in keys]
    dev, ks = ws[0].device, 32 // ws[0].element_size()
    ck = (tuple((k, tuple(packed[k].shape)) for k in keys), ks, dev)
    hit = _TC_INDEX.get(ck)
    if hit is None:
        off, parts, shapes = 1, [], []
        for k, t in zip(keys, ws):
            ii = torch.arange(off, off + t.numel(), dtype=torch.int64, device=dev)
            arranged = layouts[k](ii.view(t.shape), ks)
            parts.append(arranged.reshape(-1))
            shapes.append(tuple(arranged.shape))
            off += t.numel()
        hit = _TC_INDEX[ck] = (torch.cat(parts), shapes)
    index, shapes = hit
    flat = torch.cat([ws[0].new_zeros(1)] + [t.reshape(-1) for t in ws])[index]
    out, pos = {k: t for k, t in packed.items() if k not in layouts}, 0
    for k, shape in zip(keys, shapes):
        n = math.prod(shape)
        out[k] = flat[pos:pos + n].view(shape)
        pos += n
    return out


TRUNK_LAYOUTS = {
    "w0": lambda t, ks: tc_operand(t.t(), ks=ks),
    "w_mid": lambda t, ks: tc_operand(t.transpose(1, 2), ks=ks),
    "w_skip": lambda t, ks: tc_operand(t.transpose(1, 2), ks=ks),
}


TC_SPLIT_KEYS = ("w0", "w_mid", "w_skip")


def tc_split_weights(prepared: dict) -> dict:
    """K6's weights from :func:`tc_trunk_weights`'s: in f32 each weight split
    once into tf32 hi (under its own key) and lo (``<key>_lo``), the rounding
    of ``_bwd.split_tf32``, which K3 applies in the kernel to every chunk it
    stages; bf16 weights and the bias as they are."""
    if prepared["w0"].dtype != torch.float32:
        return prepared
    out = dict(prepared)
    for k in TC_SPLIT_KEYS:
        out[k], out[f"{k}_lo"] = _bwd.split_tf32(prepared[k])
    return out


def tc_trunk_weights(packed: dict) -> dict:
    """The trunk's packed weights prepared for ``csrc/trunk_tc.cuh``: w0,
    w_mid (per layer) and w_skip (per skip), each W^T of the packed (in, out)
    block in :func:`tc_operand`'s layout; the bias as it is."""
    return tc_gather({k: packed[k] for k in TRUNK_KEYS}, TRUNK_LAYOUTS)


class PackedWeights(dict):
    """A packed dict of ``models.field.Field.packed`` or
    ``models.field.shared_packing``. Immutable by contract (a changed
    parameter gives a new dict), so it keeps its own tensor-core
    preparations (:func:`tc_cached`), which die with it."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.prepared: dict = {}


def tc_cached(kind: str, packed: dict, make) -> dict:
    """``make()`` (the ``kind`` preparation of ``packed``'s tensors): kept in
    ``packed`` when it is a :class:`PackedWeights`, made anew on every call
    for any other dict (which may be changed in place, inference tensors
    included, where no version counter would show it)."""
    if not isinstance(packed, PackedWeights):
        return make()
    hit = packed.prepared.get(kind)
    if hit is None:
        hit = packed.prepared[kind] = make()
    return hit


# -----------------------------------------------------------------------
# forward (K3, K6)
# -----------------------------------------------------------------------


def trunk_chain(spec, x, packed):
    """The plain trunk: (h_{L-1}, [a_0 .. a_{L-1}]) with every activation and
    pre-activation in x's dtype, as the kernels store them."""
    sin = SINE_ENGINES[spec.sin_mode]
    dt, b = x.dtype, packed["b"]
    a = dot_f32(x, packed["w0"]) + b[0:1]
    acts = [a.to(dt)]
    h = sin(spec.w0 * a).to(dt)
    for i in range(1, spec.layers):
        a = dot_f32(h, packed["w_mid"][i - 1])
        if i in spec.skips:
            a = a + dot_f32(x, packed["w_skip"][spec.skips.index(i)])
        a = a + b[i : i + 1]
        acts.append(a.to(dt))
        h = sin(a).to(dt)
    return h, acts


def fused_trunk_reference(spec, x, packed, emit_acts: bool = False):
    """Plain PyTorch version of K3: (N, cx) x -> (h_{L-1} (N, F), the (L, N, F)
    pre-activations or None), both in x's dtype."""
    global FWD_PLAIN_CALLS
    FWD_PLAIN_CALLS += 1
    h, acts = trunk_chain(spec, x, packed)
    return h, (torch.stack(acts) if emit_acts else None)


class _TrunkArgs(ctypes.Structure):
    """Mirror of ``struct TrunkArgs`` in csrc/trunk_fwd.cu."""

    _fields_ = (
        [(k, ctypes.c_void_p) for k in ("x", "out", *TRUNK_KEYS, "acts_out")]
        + [(k, ctypes.c_int) for k in ("n", "layers", "feat", "cx", "skip_mask",
                                       "sin_mode", "bf16")]
        + [("w0_scale", ctypes.c_float)]
        + [(f"{k}_lo", ctypes.c_void_p) for k in TC_SPLIT_KEYS]
        + [("h_ws", ctypes.c_void_p), ("h_slots", ctypes.c_int)]
    )


def h_workspace(n: int, feat: int, dtype, device):
    """(workspace, slots) of a K1/K3 launch over ``n`` points: past
    SMEM_MAX_FEAT the two (64, feat) activation buffers of each of its
    ``slots`` persistent blocks (csrc/trunk_tc.cuh kGlobalH; one block per
    SM, as the kernels run, and at most one per 64-row tile); (None, 0) for
    the shared-memory kernels, whose grid is a block per tile."""
    if feat <= SMEM_MAX_FEAT:
        return None, 0
    slots = min(-(-n // 64), torch.cuda.get_device_properties(device).multi_processor_count)
    return torch.empty((slots, 2, 64, feat), dtype=dtype, device=device), slots


def _check_forward(name: str, spec, x, packed) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if spec.feat not in FEAT_WIDTHS:
        raise ValueError(f"{name} kernel is built for feat in {FEAT_WIDTHS}, "
                         f"got {spec.feat}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: x {x.dtype} unsupported")
    if x.ndim != 2 or x.shape[1] != spec.cx or not x.is_contiguous():
        raise ValueError(f"{name}: x {tuple(x.shape)}, expected (n, {spec.cx}) contiguous")
    for k in TRUNK_KEYS:
        t = packed[k]
        want = torch.float32 if k == "b" else x.dtype
        if t.device != x.device or not t.is_contiguous() or t.dtype != want:
            raise ValueError(f"{name}: packed[{k!r}] must be contiguous {want} on {x.device}")


def _launch_forward(fn_name: str, spec, x, packed, out, acts) -> None:
    """One launch of ``fn_name`` on the prepared weights ``packed``: those of
    :func:`tc_trunk_weights` (K3), or of :func:`tc_split_weights` (K6, whose
    f32 lo parts go to the ``*_lo`` fields)."""
    lib = load_library("trunk_fwd")
    args = _TrunkArgs()
    lo = [f"{k}_lo" for k in TC_SPLIT_KEYS]
    for k, t in (("x", x), ("out", out), ("acts_out", acts),
                 *((k, packed[k]) for k in TRUNK_KEYS),
                 *((k, packed.get(k)) for k in lo)):
        setattr(args, k, t.data_ptr() if t is not None else None)
    args.n, args.layers, args.feat, args.cx = x.shape[0], spec.layers, spec.feat, spec.cx
    args.skip_mask = sum(1 << i for i in spec.skips)
    args.sin_mode = SIN_MODES.index(spec.sin_mode)
    args.bf16 = int(x.dtype == torch.bfloat16)
    args.w0_scale = spec.w0
    h_ws, args.h_slots = h_workspace(x.shape[0], spec.feat, x.dtype, x.device)
    args.h_ws = h_ws.data_ptr() if h_ws is not None else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    check_launch(lib, getattr(lib, fn_name)(ctypes.byref(args), ctypes.c_void_p(stream)),
                 fn_name)


def _forward(spec, x, packed, emit_acts: bool):
    """(out, acts): K3 on CUDA tensors (counted in ``FWD_LAUNCHES``), the plain
    version on CPU ones."""
    global FWD_LAUNCHES
    if x.device.type == "cpu":
        return fused_trunk_reference(spec, x, packed, emit_acts)
    _check_forward("fused_trunk", spec, x, packed)
    if _bwd.padded_k(spec.cx) > TC_MAX_K:
        raise ValueError(f"fused_trunk kernel takes encoded inputs up to {TC_MAX_K} wide "
                         f"after padding to 16 (c_in <= 128, as the JAX kernels), "
                         f"got {spec.cx}")
    most = load_library("trunk_fwd").trunk_fwd_max_layers(spec.feat)
    if spec.layers > most:
        raise ValueError(f"fused_trunk kernel's plan of weight passes takes at most {most} "
                         f"layers at feat {spec.feat}, got {spec.layers}")
    n, dev = x.shape[0], x.device
    out = torch.empty((n, spec.feat), dtype=x.dtype, device=dev)
    acts = (torch.empty((spec.layers, n, spec.feat), dtype=x.dtype, device=dev)
            if emit_acts else None)
    if n:
        prepared = tc_cached(f"trunk/{x.dtype}", packed, lambda: tc_trunk_weights(packed))
        _launch_forward("trunk_fwd_forward", spec, x, prepared, out, acts)
        FWD_LAUNCHES += 1
    return out, acts


class FusedTrunk(torch.autograd.Function):
    """K3 forward (with the pre-activations for ``trunk_bwd="stored"``);
    backward = K4 (:func:`trunk_backward`). CPU tensors take the plain
    versions of both. Only first derivatives exist."""

    @staticmethod
    def forward(ctx, spec, packed, x, *weights):
        # packed: the dict that owns the weights and their preparation
        out, acts = _forward(spec, x, packed, emit_acts=spec.trunk_bwd == "stored")
        ctx.spec = spec
        ctx.save_for_backward(x, acts, *weights)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, acts, *weights = ctx.saved_tensors
        need_x = ctx.needs_input_grad[2]
        gx, *g_trunk = trunk_backward(ctx.spec, x, dict(zip(TRUNK_KEYS, weights)), acts,
                                      g.contiguous(), need_gx=need_x)
        return (None, None, gx if need_x else None,
                *(gw if need else None for gw, need in zip(g_trunk, ctx.needs_input_grad[3:])))


def fused_trunk(spec, x: torch.Tensor, packed: dict) -> torch.Tensor:
    """(N, cx) packed points in the compute dtype -> (N, F) trunk output
    h_{L-1} in the same dtype.

    Differentiable in x and the packed tensors (through :class:`FusedTrunk`
    when grad mode is on and an input requires grad; otherwise no residual is
    written). CPU tensors run :func:`fused_trunk_reference`; CUDA tensors
    launch K3 (counted in ``FWD_LAUNCHES``) or raise.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_trunk: unsupported device {x.device}")
    weights = [packed[k] for k in TRUNK_KEYS]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *weights)):
        return FusedTrunk.apply(spec, packed, x, *weights)
    return _forward(spec, x, packed, emit_acts=False)[0]


def fused_trunk_interleaved(spec, x: torch.Tensor, packed: dict,
                            emit_acts: bool = False) -> torch.Tensor:
    """K6: :func:`fused_trunk`'s function (forward only, as the prototype),
    computed by the warp-specialised ping-pong kernel of ``csrc/trunk_ws.cuh``
    on the weights K3 takes; bitwise equal to K3. It is defined for what the
    kernel takes (feat 512, at most 64 padded inputs, no pre-activations) on
    every device. CPU tensors run :func:`fused_trunk_reference`; CUDA tensors
    launch K6 (counted in ``INTERLEAVED_LAUNCHES``) or raise."""
    global INTERLEAVED_LAUNCHES
    name = "fused_trunk_interleaved"
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if spec.feat not in IL_FEAT_WIDTHS:
        raise ValueError(f"{name} kernel is built for feat in {IL_FEAT_WIDTHS}, "
                         f"got {spec.feat}")
    if _bwd.padded_k(spec.cx) > IL_MAX_K:
        raise ValueError(f"{name} kernel takes encoded inputs up to {IL_MAX_K} wide after "
                         f"padding to 16, got {spec.cx}")
    if emit_acts:
        raise ValueError(f"{name} writes no pre-activations (emit_acts)")
    if x.device.type == "cpu":
        return fused_trunk_reference(spec, x, packed)[0]
    _check_forward(name, spec, x, packed)
    out = torch.empty((x.shape[0], spec.feat), dtype=x.dtype, device=x.device)
    if x.shape[0]:
        prepared = tc_cached(f"trunk/{x.dtype}", packed, lambda: tc_trunk_weights(packed))
        split = tc_cached(f"trunk_split/{x.dtype}", packed,
                          lambda: tc_split_weights(prepared))
        _launch_forward("trunk_fwd_interleaved", spec, x, split, out, None)
        INTERLEAVED_LAUNCHES += 1
    return out


# -----------------------------------------------------------------------
# backward (K4)
# -----------------------------------------------------------------------


def _cast_grads(packed: dict, gw0, gwmid, gwskip, gb):
    return (gw0.to(packed["w0"].dtype), gwmid.to(packed["w_mid"].dtype),
            gwskip.to(packed["w_skip"].dtype), gb)


def trunk_backward_reference(spec, x, packed, acts, g_shared):
    """Plain PyTorch version of the trunk backward, step by step as
    ``_bwd_sweep``: (gx, gw0, gwmid, gwskip, gb)."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    sin, cos = SINE_ENGINES[spec.sin_mode], COSINE_ENGINES[spec.sin_mode]
    dt, L, acc = x.dtype, spec.layers, acc_dtype(x.dtype)
    w0, w_mid, w_skip, b = (packed[k] for k in ("w0", "w_mid", "w_skip", "b"))
    if acts is None:  # "recompute": pre- and post-activations from x
        a = dot_f32(x, w0) + b[0:1]
        pre, hs = [a.to(dt)], [sin(spec.w0 * a).to(dt)]
        for i in range(1, L):
            a = dot_f32(hs[-1], w_mid[i - 1])
            if i in spec.skips:
                a = a + dot_f32(x, w_skip[spec.skips.index(i)])
            a = a + b[i : i + 1]
            pre.append(a.to(dt))
            hs.append(sin(a).to(dt))
    else:  # "stored": post-activations from the stored pre-activations
        pre = [acts[i] for i in range(L)]
        hs = [sin(spec.w0 * acts[0].to(acc)).to(dt)]
        hs += [sin(acts[i].to(acc)).to(dt) for i in range(1, L - 1)]

    g = g_shared.to(dt).to(acc)
    gwmid = torch.zeros(w_mid.shape, dtype=acc, device=x.device)
    gwskip = torch.zeros(w_skip.shape, dtype=acc, device=x.device)
    gb = torch.zeros(b.shape, dtype=acc, device=x.device)
    gx_skip = torch.zeros((x.shape[0], x.shape[1]), dtype=acc, device=x.device)
    for i in range(L - 1, 0, -1):
        ga = g * cos(pre[i].to(acc))
        ga_dt = ga.to(dt)
        gwmid[i - 1] = dot_f32(hs[i - 1].t(), ga_dt)
        gb[i] = ga.sum(0)
        if i in spec.skips:
            s = spec.skips.index(i)
            gwskip[s] = dot_f32(x.t(), ga_dt)
            gx_skip = gx_skip + dot_f32(ga_dt, w_skip[s].t())
        g = dot_f32(ga_dt, w_mid[i - 1].t())
    ga0 = g * cos(spec.w0 * pre[0].to(acc)) * spec.w0
    ga0_dt = ga0.to(dt)
    gw0 = dot_f32(x.t(), ga0_dt)
    gb[0] = ga0.sum(0)
    gx = (dot_f32(ga0_dt, w0.t()) + gx_skip).to(dt)
    return (gx, *_cast_grads(packed, gw0, gwmid, gwskip, gb))


def _trunk_backward_cuda(spec, x, packed, acts, g_shared, need_gx: bool):
    """The kernel path: row launches (recompute, reverse sweep, gx) and one
    reduction (csrc/trunk_bwd.cu). The row GEMM takes W^T (out, in) for the
    forward layers and the packed (in, out) weight as it is for the sweep and
    gx; x and the rows of w0 / w_skip are padded with zeros to a multiple of
    16 once (c_in 60 -> 64, 72 -> 80; gx 64 or 128 wide). Each weight's tiles
    (``_bwd.row_weight``: in f32 split into tf32 hi + lo) are prepared here,
    once per backward. The gx launch takes at most ``_bwd.MAX_PRODS``
    products (w0's and one per skip); more skips chain launches through an
    f32 sum."""
    dt, L, F, n = x.dtype, spec.layers, spec.feat, x.shape[0]
    bf16 = dt == torch.bfloat16
    dev, f32 = x.device, torch.float32
    mode = SIN_MODES.index(spec.sin_mode)

    def row(**kw):
        _bwd.row_op("trunk_bwd", "trunk_bwd_row", dt, n, **kw)

    def operand(w):  # a weight as the row GEMM takes it, its tiles prepared once
        return _bwd.row_weight(w, dt)

    def t(w):  # (in, out) -> W^T (out, in)
        return w.t().contiguous()

    w0, w_mid, w_skip, b = (packed[k] for k in ("w0", "w_mid", "w_skip", "b"))
    kx = _bwd.padded_k(spec.cx)
    xp = _bwd.pad_cols(x, kx)

    def pad_rows(w):  # (cx, F) -> (kx, F), zero rows past cx
        return w if w.shape[0] == kx else torch.nn.functional.pad(w, (0, 0, 0, kx - w.shape[0]))

    w0p = pad_rows(w0)
    skips_p = [pad_rows(w_skip[s]) for s in range(len(spec.skips))]
    scale = [spec.w0] + [1.0] * (L - 1)
    hs = torch.empty((max(L - 1, 1), n, F), dtype=dt, device=dev)  # h_0..h_{L-2}
    if acts is None:  # "recompute": the forward again, pre- and post-activations
        acts = torch.empty((L, n, F), dtype=dt, device=dev)
        for i in range(L):
            if i == 0:
                prods = [(xp, operand(t(w0p)))]
            else:
                prods = [(hs[i - 1], operand(t(w_mid[i - 1])))]
                if i in spec.skips:
                    prods.append((xp, operand(t(skips_p[spec.skips.index(i)]))))
            row(width=F, prods=prods, bias=b[i], mode=_bwd.FWD_SINE, scale=scale[i],
                sin_mode=mode, out_dt=acts[i], out2_dt=hs[i] if i < L - 1 else None)
        write_h = False
    else:
        write_h = True  # "stored": the sweep rebuilds h_i = sin(a_i) as it goes

    ga = torch.empty((L, n, F), dtype=dt, device=dev)
    ga32 = torch.empty((L, n, F), dtype=f32, device=dev) if bf16 else ga
    g = g_shared.to(dt).contiguous()
    w_mid_b = [operand(w) for w in w_mid]  # the sweep's B: the packed (in, out) weights
    for i in range(L - 1, -1, -1):
        top = i == L - 1
        row(width=F, prods=[] if top else [(ga[i + 1], w_mid_b[i])],
            add=g if top else None, pre=acts[i], mode=_bwd.BWD_SINE,
            scale=scale[i], sin_mode=mode, out_f32=ga32[i] if bf16 else None,
            out_dt=ga[i], out2_dt=hs[i] if (write_h and i < L - 1) else None)

    gx = None
    if need_gx:
        gw = _bwd.width_for(spec.cx, GX_WIDTHS)

        def rows_to(w):  # (kx, F) -> (gw, F), zero rows past cx: gx's B
            return torch.nn.functional.pad(w, (0, 0, 0, gw - kx)).contiguous()

        prods = [(ga[0], operand(rows_to(w0p)))]
        prods += [(ga[i], operand(rows_to(skips_p[s]))) for s, i in enumerate(spec.skips)]
        gx_pad = torch.empty((n, gw), dtype=dt, device=dev)
        # at most MAX_PRODS products a launch: more skips chain launches, each
        # adding its products to the previous one's f32 sum (its ``add``)
        acc = None
        for g0 in range(0, len(prods), _bwd.MAX_PRODS):
            last = g0 + _bwd.MAX_PRODS >= len(prods)
            part = None if last else torch.empty((n, gw), dtype=f32, device=dev)
            row(width=gw, prods=prods[g0:g0 + _bwd.MAX_PRODS], add=acc, mode=_bwd.PLAIN,
                out_f32=part, out_dt=gx_pad if last else None)
            acc = part
        gx = gx_pad[:, : spec.cx]

    gw0 = torch.empty(w0.shape, dtype=f32, device=dev)
    gwmid = torch.zeros(w_mid.shape, dtype=f32, device=dev)
    gwskip = torch.zeros(w_skip.shape, dtype=f32, device=dev)
    gb = torch.empty(b.shape, dtype=f32, device=dev)
    gemms = [(x, ga[0], gw0)]
    gemms += [(hs[i - 1], ga[i], gwmid[i - 1]) for i in range(1, L)]
    gemms += [(x, ga[i], gwskip[s]) for s, i in enumerate(spec.skips)]
    sums = [(ga32[i], gb[i]) for i in range(L)]
    _bwd.reduce_op("trunk_bwd", "trunk_bwd_reduce", dt, n, gemms=gemms, sums=sums)
    return (gx, *_cast_grads(packed, gw0, gwmid, gwskip, gb))


def trunk_backward(spec, x, packed, acts, g_shared, need_gx: bool = True):
    """Gradients of the trunk: (gx (N, cx) or None, gw0, gwmid, gwskip, gb).

    ``spec`` is a ``FieldSpec`` (layers, feat, skips, cx, w0, sin_mode);
    ``x`` (N, cx) the packed input in the compute dtype; ``acts`` the
    (L, N, F) stored pre-activations, or None to recompute them; ``g_shared``
    (N, F) the gradient of the trunk output. CPU tensors run
    :func:`trunk_backward_reference` (which always returns gx); CUDA tensors
    launch the kernels (counted in ``LAUNCHES``) or raise.
    """
    global LAUNCHES
    if x.device.type == "cpu":
        return trunk_backward_reference(spec, x, packed, acts, g_shared)
    if x.device.type != "cuda":
        raise ValueError(f"trunk_backward: unsupported device {x.device}")
    n = x.shape[0]
    if spec.feat not in FEAT_WIDTHS:
        raise ValueError(f"trunk_backward kernels are built for feat in "
                         f"{FEAT_WIDTHS}, got {spec.feat}")
    if x.shape != (n, spec.cx) or not x.is_contiguous():
        raise ValueError(f"trunk_backward: x {tuple(x.shape)}, expected ({n}, {spec.cx})")
    if acts is not None and (acts.shape != (spec.layers, n, spec.feat)
                             or acts.dtype != x.dtype or not acts.is_contiguous()):
        raise ValueError(f"trunk_backward: acts {tuple(acts.shape)} {acts.dtype}")
    if g_shared.shape != (n, spec.feat) or g_shared.device != x.device:
        raise ValueError(f"trunk_backward: g_shared {tuple(g_shared.shape)}")
    if spec.layers + len(spec.skips) > _bwd.MAX_JOBS:
        raise ValueError(f"trunk_backward reduces at most {_bwd.MAX_JOBS} weight gradients a "
                         f"launch: layers + skips <= {_bwd.MAX_JOBS}, got {spec.layers} + "
                         f"{len(spec.skips)}")
    out = _trunk_backward_cuda(spec, x, packed, acts, g_shared, need_gx)
    LAUNCHES += 1
    return out

"""Fused field forward: SIREN trunk + every head in one pass per row tile.

Port of ``satnerf_tpu/ops/pallas/field_fused.py`` (the TPU kernel
``fused_field`` -> ``_fwd_kernel`` / ``_heads_forward``), forward only.
``fused_field`` launches the hand-written CUDA kernel ``csrc/field_fused.cu``
for CUDA tensors and runs :func:`fused_field_reference`, its plain PyTorch
version, for CPU tensors.

Per point it evaluates

    h_0 = sin(w0 * (x @ W_0 + b_0));  h_i = sin(h_{i-1} @ W_i [+ x @ Ws_i] + b_i)
    feats = h @ W_f + b_f
    sun-vis chain (3 sine layers on [feats, sun_d]), and with ``heads_on``
    the rgb, sky (ReLU), beta and semantic hidden layers,

and projects everything straight into one (N, 16) block of RAW
pre-nonlinearity outputs. The TPU's 128-lane output padding is dropped:
16 f32 columns hold every head as long as 9 + n_classes <= 16.

    0       sigma
    1:4     rgb (before sigmoid + rgb_padding)
    4       sun_v (before sigmoid)
    5:8     sky (before sigmoid)
    8       beta (before softplus)        [has_beta]
    9:9+C   semantic logits               [has_semantic]

``heads_on=False`` is the solar-correction variant: sigma and the sun-vis
chain only; the other columns stay 0.

Weights are packed once per (dtype, device) into the kernel's own layout
(``(in, out)`` row-major blocks; concatenated inputs split into separate
blocks, as the TPU kernel splits its GEMMs) by :func:`pack_field`.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from satnerf_torch.ops._build import load_library
from satnerf_torch.ops.fastmath import SINE_ENGINES

COL_SIGMA = 0
COL_RGB = 1
COL_SUN = 4
COL_SKY = 5
COL_BETA = 8
COL_SEM = 9
OUT_W = 16

# rows of the hidden-bias stack ``b_heads`` (absent heads keep zero rows)
HIDDEN_BIAS_ROWS = ("rgb0", "sv0", "sv1", "sv2", "sky0", "b0", "s0")
SIN_MODES = ("poly", "poly5", "poly7f")
# (feat, feat_last) pairs the kernel is instantiated for (csrc/field_fused.cu):
# every pipeline config's 512-wide trunk, with fc_use_full_features off and on
KERNEL_WIDTHS = ((512, 256), (512, 512))

LAUNCHES = 0  # kernel launches made by fused_field (CUDA tensors only)


def _round4(n: int) -> int:
    return -(-n // 4) * 4


@dataclass(frozen=True)
class FieldSpec:
    """Static fused-field architecture."""

    layers: int
    feat: int
    skips: tuple
    c_in: int  # true (unpadded) width of the encoded position
    fl: int  # head hidden width (feat_last)
    tau: int  # t-embedding width
    n_classes: int
    has_beta: bool
    has_semantic: bool
    use_tj_for_s: bool
    sep_t_s: bool  # use_separate_tj_for_semantic
    sin_mode: str = "poly"
    w0: float = 30.0
    heads_on: bool = True

    def __post_init__(self):
        if self.sin_mode not in SIN_MODES:
            raise ValueError(f"sin_mode {self.sin_mode!r} not in {SIN_MODES}")
        if 0 in self.skips:
            raise ValueError("a skip at layer 0 is not meaningful")
        if COL_SEM + self.n_classes > OUT_W:
            raise ValueError(
                f"n_classes={self.n_classes} does not fit the {OUT_W}-column "
                "packed output"
            )

    @property
    def cx(self) -> int:
        """Input width padded to a multiple of 4 (16-byte rows in f32)."""
        return _round4(self.c_in)

    @property
    def aux_t(self) -> int:
        return 3

    @property
    def aux_t_s(self) -> int:
        return 3 + self.tau

    @property
    def aux_w(self) -> int:
        """aux block: sun_d 0:3, t_emb 3:3+tau, t_s_emb 3+tau:3+2tau."""
        return _round4(3 + 2 * self.tau)

    def mac_per_point(self) -> int:
        """Multiply-adds per point of the function (not of any padding)."""
        F, fl, L = self.feat, self.fl, self.layers
        macs = self.c_in * F + (L - 1) * F * F + len(self.skips) * self.c_in * F
        macs += F * 1  # sigma
        macs += F * F  # feats
        macs += (F + 3) * fl + 2 * fl * fl + fl * 1  # sun-vis chain
        if self.heads_on:
            macs += F * fl + fl * 3  # rgb
            macs += 3 * fl + fl * 3  # sky
            if self.has_beta:
                macs += (F + self.tau) * fl + fl * 1
            if self.has_semantic:
                s_in = F + (self.tau if self.use_tj_for_s else 0)
                macs += s_in * fl + fl * self.n_classes
        return macs

    def sines_per_point(self) -> int:
        n = self.layers * self.feat + 3 * self.fl
        if self.heads_on:
            n += self.fl * (1 + int(self.has_beta) + int(self.has_semantic))
        return n


# -----------------------------------------------------------------------
# packing
# -----------------------------------------------------------------------


def _t(linear, dtype) -> torch.Tensor:
    """torch Linear weight (out, in) -> (in, out) in ``dtype``."""
    return linear.weight.detach().t().to(dtype).contiguous()


def _place_rows(w_in_out: torch.Tensor, rows: int, at: int) -> torch.Tensor:
    out = w_in_out.new_zeros((rows, w_in_out.shape[1]))
    out[at : at + w_in_out.shape[0]] = w_in_out
    return out


def _place_cols(w_in_out: torch.Tensor, at: int) -> torch.Tensor:
    out = w_in_out.new_zeros((w_in_out.shape[0], OUT_W))
    out[:, at : at + w_in_out.shape[1]] = w_in_out
    return out


def pack_field(field, spec: FieldSpec, dtype: torch.dtype) -> dict:
    """Pack a ``models.field.Field`` module into the kernel's layout.

    Weights go to ``dtype`` (the compute dtype), biases stay f32. Every
    head's blocks are packed whatever ``spec.heads_on`` says; the
    ``heads_on=False`` variant reads ``b_small_sc``, whose rgb/sky/beta/
    semantic columns are 0.
    """
    F, fl, L, cx, aw = spec.feat, spec.fl, spec.layers, spec.cx, spec.aux_w
    f32 = torch.float32
    fc = [field.fc_net[2 * i] for i in range(L)]
    p: dict = {}
    p["w0"] = _place_rows(_t(fc[0], dtype), cx, 0)
    mids, skips = [], []
    for i in range(1, L):
        w = _t(fc[i], dtype)
        if i in spec.skips:
            # reference concat order is [enc_x, h]
            skips.append(_place_rows(w[: spec.c_in], cx, 0))
            mids.append(w[spec.c_in :])
        else:
            mids.append(w)
    p["w_mid"] = torch.stack(mids).contiguous()
    p["w_skip"] = (
        torch.stack(skips).contiguous() if skips
        else p["w0"].new_zeros((1, cx, F))  # placeholder, never read
    )
    p["b"] = torch.stack([l.bias.detach().to(f32) for l in fc]).contiguous()

    p["w_feats"] = _t(field.feats_from_xyz, dtype)
    p["b_feats"] = field.feats_from_xyz.bias.detach().to(f32).contiguous()

    hb = torch.zeros((len(HIDDEN_BIAS_ROWS), fl), dtype=f32,
                     device=p["w0"].device)

    def hidden_bias(name, linear):
        hb[HIDDEN_BIAS_ROWS.index(name)] = linear.bias.detach().to(f32)

    sv = field.sun_v_net
    w_sv0 = _t(sv[0], dtype)  # (F + 3, fl)
    p["w_sv0_f"] = w_sv0[:F].contiguous()
    p["w_sv0_aux"] = _place_rows(w_sv0[F:], aw, 0)
    p["w_sv1"] = _t(sv[2], dtype)
    p["w_sv2"] = _t(sv[4], dtype)
    for name, idx in (("sv0", 0), ("sv1", 2), ("sv2", 4)):
        hidden_bias(name, sv[idx])

    p["w_rgb0"] = _t(field.rgb_from_xyzdir[0], dtype)
    hidden_bias("rgb0", field.rgb_from_xyzdir[0])
    p["w_sky0_aux"] = _place_rows(_t(field.sky_color[0], dtype), aw, 0)
    hidden_bias("sky0", field.sky_color[0])
    if spec.has_beta:
        w_b0 = _t(field.beta_from_xyz[0], dtype)  # (F + tau, fl)
        p["w_b0_f"] = w_b0[:F].contiguous()
        p["w_b0_aux"] = _place_rows(w_b0[F:], aw, spec.aux_t)
        hidden_bias("b0", field.beta_from_xyz[0])
    if spec.has_semantic:
        w_s0 = _t(field.semantic_prediction[0], dtype)  # (F [+ tau], fl)
        p["w_s0_f"] = w_s0[:F].contiguous()
        if spec.use_tj_for_s:
            at = spec.aux_t_s if spec.sep_t_s else spec.aux_t
            p["w_s0_aux"] = _place_rows(w_s0[F:], aw, at)
        hidden_bias("s0", field.semantic_prediction[0])
    p["b_heads"] = hb

    # final projections straight into the packed output columns
    p["w2_shared"] = _place_cols(_t(field.sigma_from_xyz[0], dtype), COL_SIGMA)
    p["w2_sv"] = _place_cols(_t(sv[6], dtype), COL_SUN)
    p["w2_rgb"] = _place_cols(_t(field.rgb_from_xyzdir[2], dtype), COL_RGB)
    p["w2_sky"] = _place_cols(_t(field.sky_color[2], dtype), COL_SKY)
    if spec.has_beta:
        p["w2_beta"] = _place_cols(_t(field.beta_from_xyz[2], dtype), COL_BETA)
    if spec.has_semantic:
        p["w2_sem"] = _place_cols(
            _t(field.semantic_prediction[2], dtype), COL_SEM
        )

    def bias_cols(pairs):
        bs = torch.zeros((OUT_W,), dtype=f32, device=hb.device)
        for col, linear in pairs:
            b = linear.bias.detach().to(f32)
            bs[col : col + b.shape[0]] = b
        return bs

    sc_pairs = [(COL_SIGMA, field.sigma_from_xyz[0]), (COL_SUN, sv[6])]
    full_pairs = sc_pairs + [
        (COL_RGB, field.rgb_from_xyzdir[2]), (COL_SKY, field.sky_color[2]),
    ]
    if spec.has_beta:
        full_pairs.append((COL_BETA, field.beta_from_xyz[2]))
    if spec.has_semantic:
        full_pairs.append((COL_SEM, field.semantic_prediction[2]))
    p["b_small"] = bias_cols(full_pairs)
    p["b_small_sc"] = bias_cols(sc_pairs)
    return p


def pack_x(spec: FieldSpec, enc_x: torch.Tensor, dtype) -> torch.Tensor:
    """(N, c_in) -> (N, cx) in ``dtype``, zero columns past c_in."""
    x = enc_x.to(dtype)
    if spec.cx != spec.c_in:
        x = torch.nn.functional.pad(x, (0, spec.cx - spec.c_in))
    return x.contiguous()


def pack_aux(spec: FieldSpec, sun_d, t_emb, t_s_emb, dtype) -> torch.Tensor:
    """sun_d / t_emb / t_s_emb -> one (N, aux_w) block."""
    n = sun_d.shape[0]
    aux = torch.zeros((n, spec.aux_w), dtype=dtype, device=sun_d.device)
    aux[:, 0:3] = sun_d.to(dtype)
    if t_emb is not None and spec.has_beta and spec.heads_on:
        aux[:, spec.aux_t : spec.aux_t + spec.tau] = t_emb.to(dtype)
    if t_s_emb is not None and spec.sep_t_s and spec.heads_on:
        aux[:, spec.aux_t_s : spec.aux_t_s + spec.tau] = t_s_emb.to(dtype)
    return aux


# -----------------------------------------------------------------------
# plain PyTorch version
# -----------------------------------------------------------------------


def _dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32 product of compute-dtype operands (``preferred_element_type=f32``):
    bf16 operands are upcast before the product, so it sums in f32."""
    return a.to(torch.float32) @ w.to(torch.float32)


def fused_field_reference(spec: FieldSpec, x: torch.Tensor, aux: torch.Tensor,
                          packed: dict) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (N, cx) x, (N, aux_w) aux ->
    (N, 16) f32 raw outputs. Activations are stored in x's dtype after the
    f32 sine, as the kernel stores them."""
    sin = SINE_ENGINES[spec.sin_mode]
    dt = x.dtype
    p = packed
    b = p["b"]
    a = _dot(x, p["w0"]) + b[0:1]
    h = sin(spec.w0 * a).to(dt)
    for i in range(1, spec.layers):
        a = _dot(h, p["w_mid"][i - 1])
        if i in spec.skips:
            a = a + _dot(x, p["w_skip"][spec.skips.index(i)])
        h = sin(a + b[i : i + 1]).to(dt)
    shared = h

    def bias(name):
        i = HIDDEN_BIAS_ROWS.index(name)
        return p["b_heads"][i : i + 1]

    feats = (_dot(shared, p["w_feats"]) + p["b_feats"][None]).to(dt)
    sv = sin(_dot(feats, p["w_sv0_f"]) + _dot(aux, p["w_sv0_aux"])
             + bias("sv0")).to(dt)
    sv = sin(_dot(sv, p["w_sv1"]) + bias("sv1")).to(dt)
    sv = sin(_dot(sv, p["w_sv2"]) + bias("sv2")).to(dt)
    out = _dot(shared, p["w2_shared"]) + _dot(sv, p["w2_sv"])

    if spec.heads_on:
        hr = sin(_dot(feats, p["w_rgb0"]) + bias("rgb0")).to(dt)
        out = out + _dot(hr, p["w2_rgb"])
        hsky = torch.clamp(_dot(aux, p["w_sky0_aux"]) + bias("sky0"),
                           min=0.0).to(dt)
        out = out + _dot(hsky, p["w2_sky"])
        if spec.has_beta:
            hb = sin(_dot(feats, p["w_b0_f"]) + _dot(aux, p["w_b0_aux"])
                     + bias("b0")).to(dt)
            out = out + _dot(hb, p["w2_beta"])
        if spec.has_semantic:
            a_s = _dot(feats, p["w_s0_f"]) + bias("s0")
            if spec.use_tj_for_s:
                a_s = a_s + _dot(aux, p["w_s0_aux"])
            hs = sin(a_s).to(dt)
            out = out + _dot(hs, p["w2_sem"])
        return out + p["b_small"][None]
    return out + p["b_small_sc"][None]


# -----------------------------------------------------------------------
# CUDA kernel binding
# -----------------------------------------------------------------------

_PTR_FIELDS = (
    "x", "aux", "out", "w0", "w_mid", "w_skip", "b", "w_feats", "b_feats",
    "w_sv0_f", "w_sv0_aux", "w_sv1", "w_sv2", "w_rgb0", "w_sky0_aux",
    "w_b0_f", "w_b0_aux", "w_s0_f", "w_s0_aux", "w2_shared", "w2_sv",
    "w2_rgb", "w2_sky", "w2_beta", "w2_sem", "b_heads", "b_small",
)
_INT_FIELDS = (
    "n", "layers", "feat", "fl", "cx", "aux_w", "skip_mask", "heads_on",
    "has_beta", "has_semantic", "use_s_aux", "sin_mode", "bf16",
)


class _FieldArgs(ctypes.Structure):
    """Mirror of ``struct FieldArgs`` in csrc/field_fused.cu."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in _PTR_FIELDS]
        + [(name, ctypes.c_int) for name in _INT_FIELDS]
        + [("w0_scale", ctypes.c_float)]
    )


def _launch(spec: FieldSpec, x, aux, packed, out) -> None:
    lib = load_library("field_fused")
    dt = x.dtype
    tensors = {"x": x, "aux": aux, "out": out}
    for name in _PTR_FIELDS[3:]:
        key = "b_small_sc" if (name == "b_small" and not spec.heads_on) else name
        t = packed.get(key)
        if t is not None:
            if t.device != x.device or not t.is_contiguous():
                raise ValueError(f"packed[{key!r}] must be contiguous on {x.device}")
            want = torch.float32 if name.startswith("b") else dt
            if t.dtype != want:
                raise ValueError(f"packed[{key!r}] is {t.dtype}, expected {want}")
        tensors[name] = t
    args = _FieldArgs()
    for name in _PTR_FIELDS:
        t = tensors[name]
        setattr(args, name, t.data_ptr() if t is not None else None)
    args.n = x.shape[0]
    args.layers = spec.layers
    args.feat = spec.feat
    args.fl = spec.fl
    args.cx = spec.cx
    args.aux_w = spec.aux_w
    args.skip_mask = sum(1 << i for i in spec.skips)
    args.heads_on = int(spec.heads_on)
    args.has_beta = int(spec.has_beta)
    args.has_semantic = int(spec.has_semantic)
    args.use_s_aux = int(spec.use_tj_for_s)
    args.sin_mode = SIN_MODES.index(spec.sin_mode)
    args.bf16 = int(dt == torch.bfloat16)
    args.w0_scale = spec.w0
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.field_fused_forward(ctypes.byref(args), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"field_fused kernel launch failed: cudaError {err} "
            f"({lib.satnerf_cuda_error_string(err).decode()})"
        )


def fused_field(spec: FieldSpec, x: torch.Tensor, aux: torch.Tensor,
                packed: dict) -> torch.Tensor:
    """(N, cx) points + (N, aux_w) aux -> (N, 16) raw packed head outputs.

    CPU tensors run :func:`fused_field_reference`; CUDA tensors launch the
    kernel (counted in ``LAUNCHES``) or raise.
    """
    global LAUNCHES
    if x.device.type == "cpu":
        return fused_field_reference(spec, x, aux, packed)
    if x.device.type != "cuda":
        raise ValueError(f"fused_field: unsupported device {x.device}")
    if (spec.feat, spec.fl) not in KERNEL_WIDTHS:
        raise ValueError(
            f"fused_field kernel is built for (feat, feat_last) in "
            f"{KERNEL_WIDTHS}, got {(spec.feat, spec.fl)}"
        )
    if x.dtype not in (torch.float32, torch.bfloat16) or aux.dtype != x.dtype:
        raise ValueError(f"fused_field: x {x.dtype} / aux {aux.dtype} unsupported")
    n = x.shape[0]
    if x.shape != (n, spec.cx) or aux.shape != (n, spec.aux_w):
        raise ValueError(
            f"fused_field: x {tuple(x.shape)} / aux {tuple(aux.shape)} do not "
            f"match ({n}, {spec.cx}) / ({n}, {spec.aux_w})"
        )
    if not (x.is_contiguous() and aux.is_contiguous()) or aux.device != x.device:
        raise ValueError("fused_field: x and aux must be contiguous on one device")
    out = torch.empty((n, OUT_W), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    _launch(spec, x, aux, packed, out)
    LAUNCHES += 1
    return out

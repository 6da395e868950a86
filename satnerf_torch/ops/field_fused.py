"""Fused field: SIREN trunk + every head in one pass per row tile, and its
backward.

Port of ``satnerf_tpu/ops/pallas/field_fused.py``: the TPU kernel
``fused_field`` (``_fwd_kernel`` / ``_heads_forward``, K1) and its custom
VJP (``_fused_field_bwd``: the heads backward ``_heads_bwd_kernel``, K2,
chained into the trunk backward of ``ops/trunk.py``, K4). ``fused_field``
launches the hand-written CUDA kernels (``csrc/field_fused.cu`` on the
tensor cores, with the weights of :func:`tc_weights`,
``csrc/field_bwd.cu``) for CUDA tensors and runs their plain PyTorch
versions (:func:`fused_field_reference`, :func:`heads_backward_reference`)
for CPU tensors. Under autograd it goes through :class:`FusedField`, whose
forward also writes the backward's residuals, as the TPU kernel's
``emit_shared`` / ``emit_acts`` do.

Per point it evaluates

    h_0 = sin(w0 * (x @ W_0 + b_0));  h_i = sin(h_{i-1} @ W_i [+ x @ Ws_i] + b_i)
    feats = h @ W_f + b_f
    sun-vis chain (3 sine layers on [feats, sun_d]), and with ``heads_on``
    the rgb, sky (ReLU), beta and semantic hidden layers,

and projects everything straight into one (N, out_w) block of RAW
pre-nonlinearity outputs, out_w = 9 + n_classes rounded up to 16
(:attr:`FieldSpec.out_w`): the TPU's 128-lane output padding is dropped, and
16 columns hold every head when n_classes <= 7.

    0       sigma
    1:4     rgb (before sigmoid + rgb_padding)
    4       sun_v (before sigmoid)
    5:8     sky (before sigmoid)
    8       beta (before softplus)        [has_beta]
    9:9+C   semantic logits               [has_semantic]

``heads_on=False`` is the solar-correction variant: sigma and the sun-vis
chain only; the other columns stay 0.

Weights are packed into the kernel's own layout (``(in, out)`` row-major
blocks; concatenated inputs split into separate blocks, as the TPU kernel
splits its GEMMs) by :func:`pack_field`, whose ops are differentiable, so
that under autograd the packed-layout gradients flow back to the
``nn.Linear`` parameters (as JAX's ``pack_heads`` does through its
transpose).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from torch.autograd.function import once_differentiable

from satnerf_torch.ops import _bwd, trunk
from satnerf_torch.ops.trunk import TRUNK_KEYS, dot_f32, in_out, pack_trunk, place_rows
from satnerf_torch.ops._build import check_launch, load_library
from satnerf_torch.ops.fastmath import COSINE_ENGINES, SIN_MODES, SINE_ENGINES, acc_dtype

COL_SIGMA = 0
COL_RGB = 1
COL_SUN = 4
COL_SKY = 5
COL_BETA = 8
COL_SEM = 9
# the JAX kernels' bounds (satnerf_tpu/ops/pallas/field_fused.py:97-98): the
# packed output and the aux block each fit one 128-lane block; K1 and K2 take
# both up to these widths (csrc/field_fused.cu kMaxOut, kMaxAux)
MAX_OUT_W = 128
MAX_AUX_W = 128

# rows of the hidden-bias stack ``b_heads`` (absent heads keep zero rows)
HIDDEN_BIAS_ROWS = ("rgb0", "sv0", "sv1", "sv2", "sky0", "b0", "s0")
# (feat, feat_last) pairs K1 takes (csrc/field_fused.cu ``admitted``): every
# trunk width the TPU kernel takes up to 1,024 (feat % 128 == 0) with the
# heads models/field.py sends to it (feat_last = feat / 2 or, with
# fc_use_full_features, feat; a multiple of 128, at most MAX_FL). (128, 64),
# (384, 192), (640, 320) and (896, 448) take K3 and the plain heads, as in the
# JAX package.
KERNEL_WIDTHS = ((128, 128), (256, 128), (256, 256), (384, 384), (512, 256), (512, 512),
                 (768, 384), (1024, 512))
# the JAX fused field's widest heads (satnerf_tpu/ops/pallas/field_fused.py:96)
MAX_FL = 512

LAUNCHES = 0  # K1 launches made by fused_field (CUDA tensors only)
LAUNCHES_BY_SIN = {m: 0 for m in SIN_MODES}  # the same launches, by the kernel's SinMode
HEADS_BWD_LAUNCHES = 0  # heads_backward calls that launched K2 (CUDA only)
PLAIN_CALLS = 0  # fused_field_reference and heads_backward_reference calls
# head widths K2 takes (csrc/field_bwd.cu: the row GEMM's tiles cover every
# multiple of 64, the reduction's every width); with trunk.FEAT_WIDTHS
HEADS_BWD_FL = (128, 256, 384, 512)


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def _round16(n: int) -> int:
    return -(-n // 16) * 16


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
    trunk_bwd: str = "recompute"  # "stored": the forward keeps every pre-activation

    def __post_init__(self):
        if self.trunk_bwd not in ("recompute", "stored"):
            raise ValueError(f"trunk_bwd {self.trunk_bwd!r}")
        if self.sin_mode not in SIN_MODES:
            raise ValueError(f"sin_mode {self.sin_mode!r} not in {SIN_MODES}")
        if 0 in self.skips:
            raise ValueError("a skip at layer 0 is not meaningful")
        if COL_SEM + self.n_classes > MAX_OUT_W:
            raise ValueError(
                f"n_classes={self.n_classes}: {COL_SEM} + n_classes exceeds the "
                f"{MAX_OUT_W}-column packed output"
            )
        if 3 + 2 * self.tau > MAX_AUX_W:
            raise ValueError(f"tau={self.tau}: 3 + 2 tau exceeds the {MAX_AUX_W}-column "
                             "aux block")

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

    @property
    def aux_pad(self) -> int:
        """The aux block's width in the kernels: aux_w padded to 16."""
        return _round16(self.aux_w)

    @property
    def out_w(self) -> int:
        """Columns of the packed raw output: 9 + n_classes (with the
        semantic head) rounded up to 16."""
        return _round16(COL_SEM + (self.n_classes if self.has_semantic else 0))

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

    def trunk_bwd_mac_per_point(self) -> int:
        """Multiply-adds per point of the trunk backward: dX and dW (two
        products per forward one), plus the forward again for "recompute"."""
        F, L = self.feat, self.layers
        fwd = self.c_in * F + (L - 1) * F * F + len(self.skips) * self.c_in * F
        return 2 * fwd + (fwd if self.trunk_bwd == "recompute" else 0)

    def heads_bwd_mac_per_point(self) -> int:
        """Multiply-adds per point of the heads backward: the head forward
        recomputed from the trunk output, then dX and dW of every head
        product (the trunk's share of the forward count excluded)."""
        F, L = self.feat, self.layers
        trunk_fwd = self.c_in * F + (L - 1) * F * F + len(self.skips) * self.c_in * F
        heads = self.mac_per_point() - trunk_fwd
        return 3 * heads

    def head_keys(self) -> tuple:
        """The packed head tensors this variant reads (``_heads_bwd_kernel``'s
        ``spec.head_keys()``), in a fixed order."""
        keys = ["w_feats", "b_feats", "w_sv0_f", "w_sv0_aux", "w_sv1", "w_sv2",
                "w2_shared", "w2_sv"]
        if self.heads_on:
            keys += ["w_rgb0", "w2_rgb", "w_sky0_aux", "w2_sky"]
            if self.has_beta:
                keys += ["w_b0_f", "w_b0_aux", "w2_beta"]
            if self.has_semantic:
                keys += ["w_s0_f", "w2_sem"]
                if self.use_tj_for_s:
                    keys += ["w_s0_aux"]
        keys += ["b_heads", "b_small" if self.heads_on else "b_small_sc"]
        return tuple(keys)

    def sines_per_point(self) -> int:
        n = self.layers * self.feat + 3 * self.fl
        if self.heads_on:
            n += self.fl * (1 + int(self.has_beta) + int(self.has_semantic))
        return n


# -----------------------------------------------------------------------
# packing
# -----------------------------------------------------------------------


def _place_cols(w_in_out: torch.Tensor, at: int, width: int) -> torch.Tensor:
    out = w_in_out.new_zeros((w_in_out.shape[0], width))
    out[:, at : at + w_in_out.shape[1]] = w_in_out
    return out


def pack_field(field, spec: FieldSpec, dtype: torch.dtype) -> dict:
    """Pack a ``models.field.Field`` module into the kernel's layout.

    Differentiable: under grad mode the packed tensors carry autograd history
    back to the module's parameters. Weights go to ``dtype`` (the compute
    dtype), biases to f32 (f64 for f64). Every
    head's blocks are packed whatever ``spec.heads_on`` says; the
    ``heads_on=False`` variant reads ``b_small_sc``, whose rgb/sky/beta/
    semantic columns are 0.
    """
    F, fl, aw, ow = spec.feat, spec.fl, spec.aux_w, spec.out_w
    bias_dt = acc_dtype(dtype)
    p: dict = pack_trunk(field, spec, dtype)

    p["w_feats"] = in_out(field.feats_from_xyz, dtype)
    p["b_feats"] = field.feats_from_xyz.bias.to(bias_dt).contiguous()

    hb = torch.zeros((len(HIDDEN_BIAS_ROWS), fl), dtype=bias_dt,
                     device=p["w0"].device)

    def hidden_bias(name, linear):
        hb[HIDDEN_BIAS_ROWS.index(name)] = linear.bias.to(bias_dt)

    sv = field.sun_v_net
    w_sv0 = in_out(sv[0], dtype)  # (F + 3, fl)
    p["w_sv0_f"] = w_sv0[:F].contiguous()
    p["w_sv0_aux"] = place_rows(w_sv0[F:], aw, 0)
    p["w_sv1"] = in_out(sv[2], dtype)
    p["w_sv2"] = in_out(sv[4], dtype)
    for name, idx in (("sv0", 0), ("sv1", 2), ("sv2", 4)):
        hidden_bias(name, sv[idx])

    p["w_rgb0"] = in_out(field.rgb_from_xyzdir[0], dtype)
    hidden_bias("rgb0", field.rgb_from_xyzdir[0])
    p["w_sky0_aux"] = place_rows(in_out(field.sky_color[0], dtype), aw, 0)
    hidden_bias("sky0", field.sky_color[0])
    if spec.has_beta:
        w_b0 = in_out(field.beta_from_xyz[0], dtype)  # (F + tau, fl)
        p["w_b0_f"] = w_b0[:F].contiguous()
        p["w_b0_aux"] = place_rows(w_b0[F:], aw, spec.aux_t)
        hidden_bias("b0", field.beta_from_xyz[0])
    if spec.has_semantic:
        w_s0 = in_out(field.semantic_prediction[0], dtype)  # (F [+ tau], fl)
        p["w_s0_f"] = w_s0[:F].contiguous()
        if spec.use_tj_for_s:
            at = spec.aux_t_s if spec.sep_t_s else spec.aux_t
            p["w_s0_aux"] = place_rows(w_s0[F:], aw, at)
        hidden_bias("s0", field.semantic_prediction[0])
    p["b_heads"] = hb

    # final projections straight into the packed output columns
    p["w2_shared"] = _place_cols(in_out(field.sigma_from_xyz[0], dtype), COL_SIGMA, ow)
    p["w2_sv"] = _place_cols(in_out(sv[6], dtype), COL_SUN, ow)
    p["w2_rgb"] = _place_cols(in_out(field.rgb_from_xyzdir[2], dtype), COL_RGB, ow)
    p["w2_sky"] = _place_cols(in_out(field.sky_color[2], dtype), COL_SKY, ow)
    if spec.has_beta:
        p["w2_beta"] = _place_cols(in_out(field.beta_from_xyz[2], dtype), COL_BETA, ow)
    if spec.has_semantic:
        p["w2_sem"] = _place_cols(
            in_out(field.semantic_prediction[2], dtype), COL_SEM, ow
        )

    def bias_cols(pairs):
        bs = torch.zeros((ow,), dtype=bias_dt, device=hb.device)
        for col, linear in pairs:
            b = linear.bias.to(bias_dt)
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


def _reference_forward(spec: FieldSpec, x, aux, packed, resid: bool):
    """(out, shared, acts) of the plain forward; shared and acts only when
    ``resid`` (acts only for ``trunk_bwd="stored"``), as the kernel writes
    them."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    sin = SINE_ENGINES[spec.sin_mode]
    dt = x.dtype
    p = packed
    shared, acts = trunk.trunk_chain(spec, x, p)

    def bias(name):
        i = HIDDEN_BIAS_ROWS.index(name)
        return p["b_heads"][i : i + 1]

    feats = (dot_f32(shared, p["w_feats"]) + p["b_feats"][None]).to(dt)
    sv = sin(dot_f32(feats, p["w_sv0_f"]) + dot_f32(aux, p["w_sv0_aux"])
             + bias("sv0")).to(dt)
    sv = sin(dot_f32(sv, p["w_sv1"]) + bias("sv1")).to(dt)
    sv = sin(dot_f32(sv, p["w_sv2"]) + bias("sv2")).to(dt)
    out = dot_f32(shared, p["w2_shared"]) + dot_f32(sv, p["w2_sv"])

    if spec.heads_on:
        hr = sin(dot_f32(feats, p["w_rgb0"]) + bias("rgb0")).to(dt)
        out = out + dot_f32(hr, p["w2_rgb"])
        hsky = torch.clamp(dot_f32(aux, p["w_sky0_aux"]) + bias("sky0"),
                           min=0.0).to(dt)
        out = out + dot_f32(hsky, p["w2_sky"])
        if spec.has_beta:
            hb = sin(dot_f32(feats, p["w_b0_f"]) + dot_f32(aux, p["w_b0_aux"])
                     + bias("b0")).to(dt)
            out = out + dot_f32(hb, p["w2_beta"])
        if spec.has_semantic:
            a_s = dot_f32(feats, p["w_s0_f"]) + bias("s0")
            if spec.use_tj_for_s:
                a_s = a_s + dot_f32(aux, p["w_s0_aux"])
            hs = sin(a_s).to(dt)
            out = out + dot_f32(hs, p["w2_sem"])
        out = out + p["b_small"][None]
    else:
        out = out + p["b_small_sc"][None]
    if not resid:
        return out, None, None
    stored = torch.stack(acts) if spec.trunk_bwd == "stored" else None
    return out, shared, stored


def fused_field_reference(spec: FieldSpec, x: torch.Tensor, aux: torch.Tensor,
                          packed: dict) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (N, cx) x, (N, aux_w) aux ->
    (N, out_w) f32 raw outputs. Activations are stored in x's dtype after the
    f32 sine, as the kernel stores them."""
    return _reference_forward(spec, x, aux, packed, resid=False)[0]


def heads_backward_reference(spec: FieldSpec, shared, aux, g_out, packed, trace=None):
    """Plain PyTorch version of the heads backward, as ``_heads_bwd_kernel``:
    (g_shared (N, F), g_aux (N, aux_w), {head key: gradient}). Sums run in
    f32, in f64 for f64 operands. A ``trace`` dict receives the
    intermediates under the names of the kernel's workspaces (``feats``,
    ``pre``/``hid``/``ga`` by head layer, ``g_feats``)."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    sin, cos = SINE_ENGINES[spec.sin_mode], COSINE_ENGINES[spec.sin_mode]
    dt, acc = shared.dtype, acc_dtype(shared.dtype)
    p = packed

    def bias(name):
        i = HIDDEN_BIAS_ROWS.index(name)
        return p["b_heads"][i : i + 1]

    def dot_t(a, w):  # a @ w^T
        return dot_f32(a, w.t())

    def dot_at(a, b):  # a^T @ b
        return dot_f32(a.t(), b)

    g_dt = g_out.to(dt)
    # recompute the head hiddens
    feats = (dot_f32(shared, p["w_feats"]) + p["b_feats"][None]).to(dt)
    a_sv1 = dot_f32(feats, p["w_sv0_f"]) + dot_f32(aux, p["w_sv0_aux"]) + bias("sv0")
    sv1 = sin(a_sv1).to(dt)
    a_sv2 = dot_f32(sv1, p["w_sv1"]) + bias("sv1")
    sv2 = sin(a_sv2).to(dt)
    a_sv3 = dot_f32(sv2, p["w_sv2"]) + bias("sv2")
    sv3 = sin(a_sv3).to(dt)
    if spec.heads_on:
        a_hr = dot_f32(feats, p["w_rgb0"]) + bias("rgb0")
        hr = sin(a_hr).to(dt)
        a_sky = dot_f32(aux, p["w_sky0_aux"]) + bias("sky0")
        hsky = torch.clamp(a_sky, min=0.0).to(dt)
        if spec.has_beta:
            a_hb = dot_f32(feats, p["w_b0_f"]) + dot_f32(aux, p["w_b0_aux"]) + bias("b0")
            hbet = sin(a_hb).to(dt)
        if spec.has_semantic:
            a_hs = dot_f32(feats, p["w_s0_f"]) + bias("s0")
            if spec.use_tj_for_s:
                a_hs = a_hs + dot_f32(aux, p["w_s0_aux"])
            hs = sin(a_hs).to(dt)

    # reverse sweep
    gw, gb_rows = {}, []
    g_shared = dot_t(g_dt, p["w2_shared"])
    gw["w2_shared"] = dot_at(shared, g_dt)
    g_feats = None
    if spec.heads_on:
        gw["w2_rgb"] = dot_at(hr, g_dt)
        ga_hr = (dot_t(g_dt, p["w2_rgb"]) * cos(a_hr)).to(dt)
        gw["w_rgb0"] = dot_at(feats, ga_hr)
        g_feats = dot_t(ga_hr, p["w_rgb0"])
        gb_rows.append(("rgb0", ga_hr))
    gw["w2_sv"] = dot_at(sv3, g_dt)
    ga3 = (dot_t(g_dt, p["w2_sv"]) * cos(a_sv3)).to(dt)
    gw["w_sv2"] = dot_at(sv2, ga3)
    ga2 = (dot_t(ga3, p["w_sv2"]) * cos(a_sv2)).to(dt)
    gw["w_sv1"] = dot_at(sv1, ga2)
    ga1 = (dot_t(ga2, p["w_sv1"]) * cos(a_sv1)).to(dt)
    gw["w_sv0_f"] = dot_at(feats, ga1)
    gw["w_sv0_aux"] = dot_at(aux, ga1)
    g_sv_feats = dot_t(ga1, p["w_sv0_f"])
    g_feats = g_sv_feats if g_feats is None else g_feats + g_sv_feats
    g_aux = dot_t(ga1, p["w_sv0_aux"])
    gb_rows += [("sv2", ga3), ("sv1", ga2), ("sv0", ga1)]
    if spec.heads_on:
        gw["w2_sky"] = dot_at(hsky, g_dt)
        ga_sky = torch.where(a_sky > 0.0, dot_t(g_dt, p["w2_sky"]), 0.0).to(dt)
        gw["w_sky0_aux"] = dot_at(aux, ga_sky)
        g_aux = g_aux + dot_t(ga_sky, p["w_sky0_aux"])
        gb_rows.append(("sky0", ga_sky))
        if spec.has_beta:
            gw["w2_beta"] = dot_at(hbet, g_dt)
            ga_hb = (dot_t(g_dt, p["w2_beta"]) * cos(a_hb)).to(dt)
            gw["w_b0_f"] = dot_at(feats, ga_hb)
            gw["w_b0_aux"] = dot_at(aux, ga_hb)
            g_feats = g_feats + dot_t(ga_hb, p["w_b0_f"])
            g_aux = g_aux + dot_t(ga_hb, p["w_b0_aux"])
            gb_rows.append(("b0", ga_hb))
        if spec.has_semantic:
            gw["w2_sem"] = dot_at(hs, g_dt)
            ga_hs = (dot_t(g_dt, p["w2_sem"]) * cos(a_hs)).to(dt)
            gw["w_s0_f"] = dot_at(feats, ga_hs)
            g_feats = g_feats + dot_t(ga_hs, p["w_s0_f"])
            if spec.use_tj_for_s:
                gw["w_s0_aux"] = dot_at(aux, ga_hs)
                g_aux = g_aux + dot_t(ga_hs, p["w_s0_aux"])
            gb_rows.append(("s0", ga_hs))
    # feats = shared @ w_feats + b (linear)
    g_feats_dt = g_feats.to(dt)
    gw["w_feats"] = dot_at(shared, g_feats_dt)
    g_shared = g_shared + dot_t(g_feats_dt, p["w_feats"])
    gw["b_feats"] = g_feats.sum(0)
    gb = torch.zeros(p["b_heads"].shape, dtype=acc, device=shared.device)
    for name, ga in gb_rows:
        gb[HIDDEN_BIAS_ROWS.index(name)] = ga.to(acc).sum(0)
    gw["b_heads"] = gb
    gw["b_small" if spec.heads_on else "b_small_sc"] = g_out.to(acc).sum(0)
    if trace is not None:
        pre = {"sv0": a_sv1, "sv1": a_sv2, "sv2": a_sv3}
        hid = {"sv0": sv1, "sv1": sv2, "sv2": sv3}
        if spec.heads_on:
            pre.update(rgb0=a_hr, sky0=a_sky)
            hid.update(rgb0=hr, sky0=hsky)
            if spec.has_beta:
                pre["b0"], hid["b0"] = a_hb, hbet
            if spec.has_semantic:
                pre["s0"], hid["s0"] = a_hs, hs
        trace.update(feats=feats, pre=pre, hid=hid, ga=dict(gb_rows), g_feats=g_feats)
    g_heads = {k: gw[k].to(p[k].dtype) for k in spec.head_keys()}
    return g_shared.to(dt), g_aux.to(dt), g_heads


# -----------------------------------------------------------------------
# weights for the tensor-core kernel
# -----------------------------------------------------------------------

# the f32 projections' K order within each group of 8: the wgmma accumulator
# holds columns (2t, 2t + 1) where the tf32 A fragment takes (t, t + 4)
PROJ_PERM = (0, 2, 4, 6, 1, 3, 5, 7)


def tc_projection(w: torch.Tensor, ks: int | None = None) -> torch.Tensor:
    """A projection (K, out_w) as K1 takes it: W^T (out_w, K), in f32 (8
    elements per k-step) with K permuted within each group of 8 by
    :data:`PROJ_PERM`, in :func:`trunk.tc_operand`'s layout for 16 rows: its
    16-column groups (16, K) one after the other, each as one m64n16
    projection reads it."""
    ks = ks or 32 // w.element_size()
    wt = w.t()
    if ks == 8:
        k = wt.shape[1]
        idx = torch.arange(k, device=w.device).view(-1, 8)[:, list(PROJ_PERM)].reshape(-1)
        wt = wt[:, idx]
    return trunk.tc_operand(wt, rows=16, ks=ks)


def tc_weights(packed: dict) -> dict:
    """The packed field prepared for ``csrc/field_fused.cu``: the trunk as
    :func:`trunk.tc_trunk_weights`, every head weight W^T (out, in) with K
    padded to a multiple of 16 (the aux rows aux_w -> aux_pad,
    :func:`trunk.tc_operand`), the projections by :func:`tc_projection`,
    the biases as they are; one gather (:func:`trunk.tc_gather`)."""
    layouts = dict(trunk.TRUNK_LAYOUTS)
    for k in packed:
        if k.startswith("w2_"):
            layouts[k] = lambda t, ks: tc_projection(t, ks)
        elif k.startswith("w") and k not in layouts:
            layouts[k] = lambda t, ks: trunk.tc_operand(t.t(), ks=ks)
    return trunk.tc_gather(packed, layouts)


# -----------------------------------------------------------------------
# CUDA kernel binding
# -----------------------------------------------------------------------

_PTR_FIELDS = (
    "x", "aux", "out", "w0", "w_mid", "w_skip", "b", "w_feats", "b_feats",
    "w_sv0_f", "w_sv0_aux", "w_sv1", "w_sv2", "w_rgb0", "w_sky0_aux",
    "w_b0_f", "w_b0_aux", "w_s0_f", "w_s0_aux", "w2_shared", "w2_sv",
    "w2_rgb", "w2_sky", "w2_beta", "w2_sem", "b_heads", "b_small",
    "shared_out", "acts_out", "acc", "h_ws",
)
_INT_FIELDS = (
    "h_slots", "n", "layers", "feat", "fl", "cx", "aux_w", "out_w", "skip_mask", "heads_on",
    "has_beta", "has_semantic", "use_s_aux", "sin_mode", "bf16",
)
ACC_FLOATS = 256 * 8  # K1's output accumulators per 64-row tile and 16-column group


def acc_workspace(spec: FieldSpec, n: int, device, blocks: int | None = None) -> torch.Tensor:
    """K1's output accumulators in global memory: per block (a 64-row tile,
    or one of ``blocks`` persistent blocks) and 16-column group of the
    output, 8 f32 for each of the block's 256 threads (csrc/field_fused.cu)."""
    return torch.empty(((blocks or -(-n // 64)) * (spec.out_w // 16) * ACC_FLOATS,),
                       dtype=torch.float32, device=device)


class _FieldArgs(ctypes.Structure):
    """Mirror of ``struct FieldArgs`` in csrc/field_fused.cu."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in _PTR_FIELDS]
        + [(name, ctypes.c_int) for name in _INT_FIELDS]
        + [("w0_scale", ctypes.c_float)]
    )


def _launch(spec: FieldSpec, x, aux, packed, out, shared=None, acts=None) -> None:
    """One K1 launch on the weights of :func:`tc_weights` (made from
    ``packed``, reused while ``packed`` is unchanged)."""
    lib = load_library("field_fused")
    dt = x.dtype
    keys = {}
    for name in _PTR_FIELDS[3:]:
        key = "b_small_sc" if (name == "b_small" and not spec.heads_on) else name
        t = packed.get(key)
        if t is not None:
            if t.device != x.device or not t.is_contiguous():
                raise ValueError(f"packed[{key!r}] must be contiguous on {x.device}")
            want = torch.float32 if name.startswith("b") else dt
            if t.dtype != want:
                raise ValueError(f"packed[{key!r}] is {t.dtype}, expected {want}")
        keys[name] = key
    prepared = trunk.tc_cached(f"field/{dt}", packed, lambda: tc_weights(packed))
    tensors = {"x": x, "aux": aux, "out": out}
    for name, key in keys.items():
        tensors[name] = prepared.get(key)
    tensors["shared_out"], tensors["acts_out"] = shared, acts
    tensors["h_ws"], slots = trunk.h_workspace(x.shape[0], spec.feat, dt, x.device)
    tensors["acc"] = acc_workspace(spec, x.shape[0], x.device, slots)
    args = _FieldArgs()
    for name in _PTR_FIELDS:
        t = tensors[name]
        setattr(args, name, t.data_ptr() if t is not None else None)
    args.h_slots = slots
    args.n = x.shape[0]
    args.layers = spec.layers
    args.feat = spec.feat
    args.fl = spec.fl
    args.cx = spec.cx
    args.aux_w = spec.aux_w
    args.out_w = spec.out_w
    args.skip_mask = sum(1 << i for i in spec.skips)
    args.heads_on = int(spec.heads_on)
    args.has_beta = int(spec.has_beta)
    args.has_semantic = int(spec.has_semantic)
    args.use_s_aux = int(spec.use_tj_for_s)
    args.sin_mode = SIN_MODES.index(spec.sin_mode)
    args.bf16 = int(dt == torch.bfloat16)
    args.w0_scale = spec.w0
    stream = torch.cuda.current_stream(x.device).cuda_stream
    check_launch(lib, lib.field_fused_forward(ctypes.byref(args), ctypes.c_void_p(stream)),
                 "field_fused")


def _check_cuda(spec: FieldSpec, x: torch.Tensor, aux: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"fused_field: unsupported device {x.device}")
    if (spec.feat, spec.fl) not in KERNEL_WIDTHS:
        raise ValueError(
            f"fused_field kernel is built for (feat, feat_last) in "
            f"{KERNEL_WIDTHS}, got {(spec.feat, spec.fl)}"
        )
    if x.dtype not in (torch.float32, torch.bfloat16) or aux.dtype != x.dtype:
        raise ValueError(f"fused_field: x {x.dtype} / aux {aux.dtype} unsupported")
    if (_bwd.padded_k(spec.cx) > trunk.TC_MAX_K or spec.aux_pad > MAX_AUX_W
            or spec.out_w > MAX_OUT_W):
        raise ValueError(f"fused_field kernel takes encoded inputs up to {trunk.TC_MAX_K} "
                         f"wide after padding to 16 (c_in <= 128, as the JAX kernels), "
                         f"{MAX_AUX_W} aux columns and {MAX_OUT_W} output columns, got "
                         f"{spec.cx} / {spec.aux_w} / {spec.out_w}")
    most = load_library("field_fused").field_fused_max_layers(ctypes.byref(_FieldArgs(
        feat=spec.feat, fl=spec.fl, out_w=spec.out_w, heads_on=int(spec.heads_on),
        has_semantic=int(spec.has_semantic))))
    if spec.layers > most:
        raise ValueError(f"fused_field kernel's plan of weight passes takes at most {most} "
                         f"layers at ({spec.feat}, {spec.fl}) with {spec.out_w} output "
                         f"columns, got {spec.layers}")
    n = x.shape[0]
    if x.shape != (n, spec.cx) or aux.shape != (n, spec.aux_w):
        raise ValueError(
            f"fused_field: x {tuple(x.shape)} / aux {tuple(aux.shape)} do not "
            f"match ({n}, {spec.cx}) / ({n}, {spec.aux_w})"
        )
    if not (x.is_contiguous() and aux.is_contiguous()) or aux.device != x.device:
        raise ValueError("fused_field: x and aux must be contiguous on one device")


def _forward(spec: FieldSpec, x, aux, packed, resid: bool):
    """(out, shared, acts): K1 on CUDA tensors (counted in ``LAUNCHES``), the
    plain version on CPU ones. ``resid`` asks for the backward's residuals."""
    global LAUNCHES
    if x.device.type == "cpu":
        return _reference_forward(spec, x, aux, packed, resid)
    _check_cuda(spec, x, aux)
    n, dev = x.shape[0], x.device
    out = torch.empty((n, spec.out_w), dtype=torch.float32, device=dev)
    shared = acts = None
    if resid:
        shared = torch.empty((n, spec.feat), dtype=x.dtype, device=dev)
        if spec.trunk_bwd == "stored":
            acts = torch.empty((spec.layers, n, spec.feat), dtype=x.dtype, device=dev)
    if n:
        _launch(spec, x, aux, packed, out, shared, acts)
        LAUNCHES += 1
        LAUNCHES_BY_SIN[spec.sin_mode] += 1
    return out, shared, acts


# -----------------------------------------------------------------------
# heads backward (K2) on the card
# -----------------------------------------------------------------------


def heads_reduce_pairs(spec: FieldSpec, shared, aux, g, feats, hid, ga, g_feats) -> dict:
    """{head weight key: (A, B)}: every dW = A^T B of K2's reduction, on the
    workspaces of :func:`_heads_backward_cuda` (``hid``, ``ga`` by head
    layer)."""
    pairs = {
        "w2_shared": (shared, g), "w_feats": (shared, g_feats),
        "w_sv0_f": (feats, ga["sv0"]), "w_sv0_aux": (aux, ga["sv0"]),
        "w_sv1": (hid["sv0"], ga["sv1"]), "w_sv2": (hid["sv1"], ga["sv2"]),
        "w2_sv": (hid["sv2"], g),
    }
    if spec.heads_on:
        pairs.update({
            "w_rgb0": (feats, ga["rgb0"]), "w2_rgb": (hid["rgb0"], g),
            "w_sky0_aux": (aux, ga["sky0"]), "w2_sky": (hid["sky0"], g),
        })
        if spec.has_beta:
            pairs.update({"w_b0_f": (feats, ga["b0"]), "w_b0_aux": (aux, ga["b0"]),
                          "w2_beta": (hid["b0"], g)})
        if spec.has_semantic:
            pairs.update({"w_s0_f": (feats, ga["s0"]), "w2_sem": (hid["s0"], g)})
            if spec.use_tj_for_s:
                pairs["w_s0_aux"] = (aux, ga["s0"])
    return pairs


def g_aux_width(spec: FieldSpec) -> int:
    """The g_aux launch's width: aux_pad 16 on the FMA row kernel; wider
    blocks padded to the tensor-core row GEMM's 64-column tiles (the fixed
    rule on shape of csrc/bwd_common.cuh)."""
    return spec.aux_pad if spec.aux_pad == _bwd.THIN_WIDTH else -(-spec.aux_pad // 64) * 64


def _heads_backward_cuda(spec: FieldSpec, shared, aux, g_out, packed, need_aux, trace=None):
    """K2: row launches (recompute, reverse sweep, g_feats, g_aux, g_shared)
    and one reduction of ``csrc/field_bwd.cu``. The row GEMM takes W^T
    (out, in) for the recomputed layers and the packed (in, out) weight as
    it is for the reverse sweep; the aux block and the aux rows of the
    weights are padded with zeros to ``spec.aux_pad`` columns / rows (the
    g_aux launch's to :func:`g_aux_width`). A ``trace`` dict receives the
    workspaces as :func:`heads_backward_reference` names them."""
    dt, f32, dev = shared.dtype, torch.float32, shared.device
    n, F, fl = shared.shape[0], spec.feat, spec.fl
    bf16 = dt == torch.bfloat16
    mode = SIN_MODES.index(spec.sin_mode)
    p = packed
    ka, wa = spec.aux_pad, g_aux_width(spec)

    def row(**kw):
        _bwd.row_op("field_bwd", "heads_bwd_row", dt, n, **kw)

    def ws(width, dtype=dt):
        return torch.empty((n, width), dtype=dtype, device=dev)

    def t(key):  # packed (in, out) -> W^T (out, in), aux rows padded to aux_pad columns
        w = p[key].t()
        return (_bwd.pad_cols(w, ka) if key.endswith("_aux") else w).contiguous()

    def b_aux(key):  # an aux weight (aux_w, out) as the sweep's B: rows padded to wa
        return torch.nn.functional.pad(p[key], (0, 0, 0, wa - spec.aux_w))

    def hb(name):
        return p["b_heads"][HIDDEN_BIAS_ROWS.index(name)]

    g32 = g_out.to(f32).contiguous()
    g = g32.to(dt)
    auxp = _bwd.pad_cols(aux, ka)
    feats = ws(F)
    row(width=F, prods=[(shared, t("w_feats"))], bias=p["b_feats"],
        mode=_bwd.FWD_LINEAR, out_dt=feats)
    pre, hid = {}, {}

    def fwd(name, prods, relu=False):
        pre[name], hid[name] = ws(fl, f32), ws(fl)
        row(width=fl, prods=prods, bias=hb(name), sin_mode=mode,
            mode=_bwd.FWD_RELU if relu else _bwd.FWD_SINE,
            out_f32=pre[name], out2_dt=hid[name])

    fwd("sv0", [(feats, t("w_sv0_f")), (auxp, t("w_sv0_aux"))])
    fwd("sv1", [(hid["sv0"], t("w_sv1"))])
    fwd("sv2", [(hid["sv1"], t("w_sv2"))])
    if spec.heads_on:
        fwd("rgb0", [(feats, t("w_rgb0"))])
        fwd("sky0", [(auxp, t("w_sky0_aux"))], relu=True)
        if spec.has_beta:
            fwd("b0", [(feats, t("w_b0_f")), (auxp, t("w_b0_aux"))])
        if spec.has_semantic:
            s_prods = [(feats, t("w_s0_f"))]
            if spec.use_tj_for_s:
                s_prods.append((auxp, t("w_s0_aux")))
            fwd("s0", s_prods)

    ga = {}

    def bwd(name, a, w, relu=False):  # w: the packed (in, out) weight, the sweep's B
        ga[name] = ws(fl)
        row(width=fl, prods=[(a, w)], pre=pre[name], sin_mode=mode,
            mode=_bwd.BWD_RELU if relu else _bwd.BWD_SINE, out_dt=ga[name])

    if spec.heads_on:
        bwd("rgb0", g, p["w2_rgb"])
    bwd("sv2", g, p["w2_sv"])
    bwd("sv1", ga["sv2"], p["w_sv2"])
    bwd("sv0", ga["sv1"], p["w_sv1"])
    f_prods = [(ga["sv0"], p["w_sv0_f"])]
    a_prods = [(ga["sv0"], b_aux("w_sv0_aux"))]
    if spec.heads_on:
        f_prods.insert(0, (ga["rgb0"], p["w_rgb0"]))
        bwd("sky0", g, p["w2_sky"], relu=True)
        a_prods.append((ga["sky0"], b_aux("w_sky0_aux")))
        if spec.has_beta:
            bwd("b0", g, p["w2_beta"])
            f_prods.append((ga["b0"], p["w_b0_f"]))
            a_prods.append((ga["b0"], b_aux("w_b0_aux")))
        if spec.has_semantic:
            bwd("s0", g, p["w2_sem"])
            f_prods.append((ga["s0"], p["w_s0_f"]))
            if spec.use_tj_for_s:
                a_prods.append((ga["s0"], b_aux("w_s0_aux")))
    g_feats32 = ws(F, f32)
    g_feats = ws(F) if bf16 else g_feats32
    row(width=F, prods=f_prods, mode=_bwd.PLAIN, out_f32=g_feats32,
        out_dt=g_feats if bf16 else None)
    g_aux = None
    if need_aux:  # 16 wide: the FMA row kernel; wider: the tensor-core one
        g_aux_pad = ws(wa)
        row(width=wa, prods=a_prods, mode=_bwd.PLAIN, out_dt=g_aux_pad)
        g_aux = g_aux_pad[:, : spec.aux_w]
    g_shared = ws(F)
    row(width=F, prods=[(g, p["w2_shared"]), (g_feats, p["w_feats"])],
        mode=_bwd.PLAIN, out_dt=g_shared)

    # every head dW = A^T B and db = sum B in one reduction
    gw = {k: torch.empty(p[k].shape, dtype=f32, device=dev)
          for k in spec.head_keys()}
    pairs = heads_reduce_pairs(spec, shared, aux, g, feats, hid, ga, g_feats)
    gemms = [(a, b, gw[k]) for k, (a, b) in pairs.items()]
    gw["b_heads"].zero_()  # rows of absent heads stay 0
    sums = [(g_feats32, gw["b_feats"])]
    sums += [(t, gw["b_heads"][HIDDEN_BIAS_ROWS.index(name)]) for name, t in ga.items()]
    small = "b_small" if spec.heads_on else "b_small_sc"
    sums.append((g32, gw[small]))
    _bwd.reduce_op("field_bwd", "heads_bwd_reduce", dt, n, gemms=gemms, sums=sums)
    if trace is not None:
        trace.update(feats=feats, pre=pre, hid=hid, ga=ga, g_feats=g_feats32)
    g_heads = {k: gw[k].to(p[k].dtype) for k in spec.head_keys()}
    return g_shared, g_aux, g_heads


def heads_backward(spec: FieldSpec, shared, aux, g_out, packed, need_aux: bool = True,
                   trace=None):
    """Heads backward: the trunk output ``shared`` (N, F), ``aux``
    (N, aux_w) and the gradient ``g_out`` of the raw (N, out_w) columns ->
    (g_shared (N, F), g_aux (N, aux_w) or None, {head key: gradient}).

    CPU tensors run :func:`heads_backward_reference` (which always returns
    g_aux); CUDA tensors launch K2 (counted in ``HEADS_BWD_LAUNCHES``) or
    raise. A ``trace`` dict receives the intermediates (the head layers'
    pre-activations under ``pre``, ...) by the plain version's names.
    """
    global HEADS_BWD_LAUNCHES
    if shared.device.type == "cpu":
        return heads_backward_reference(spec, shared, aux, g_out, packed, trace)
    if shared.device.type != "cuda":
        raise ValueError(f"heads_backward: unsupported device {shared.device}")
    n = shared.shape[0]
    if spec.feat not in trunk.FEAT_WIDTHS or spec.fl not in HEADS_BWD_FL:
        raise ValueError(f"heads_backward kernels are built for feat in "
                         f"{trunk.FEAT_WIDTHS}, feat_last in {HEADS_BWD_FL}")
    if spec.aux_pad > MAX_AUX_W or spec.out_w > MAX_OUT_W:
        raise ValueError(f"heads_backward: aux width {spec.aux_w} / output width "
                         f"{spec.out_w} past {MAX_AUX_W} / {MAX_OUT_W}")
    if (shared.shape != (n, spec.feat) or aux.shape != (n, spec.aux_w)
            or g_out.shape != (n, spec.out_w) or not shared.is_contiguous()
            or not aux.is_contiguous() or aux.dtype != shared.dtype):
        raise ValueError(f"heads_backward: shared {tuple(shared.shape)}, aux "
                         f"{tuple(aux.shape)} {aux.dtype}, g {tuple(g_out.shape)}")
    out = _heads_backward_cuda(spec, shared, aux, g_out, packed, need_aux, trace)
    HEADS_BWD_LAUNCHES += 1
    return out


# -----------------------------------------------------------------------
# the differentiable entry point
# -----------------------------------------------------------------------


class FusedField(torch.autograd.Function):
    """K1 forward with residuals; backward = K2 chained into K4, as
    ``_fused_field_bwd`` chains ``_heads_bwd_kernel`` into the trunk
    backward. CPU tensors take the plain versions of all three. Only first
    derivatives exist: a double backward raises."""

    @staticmethod
    def forward(ctx, spec, keys, packed, x, aux, *weights):
        # packed: the dict that owns the weights and their preparation
        out, shared, acts = _forward(spec, x, aux, packed, resid=True)
        ctx.spec, ctx.keys = spec, keys
        ctx.save_for_backward(x, aux, shared, acts, *weights)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g_out):
        x, aux, shared, acts, *weights = ctx.saved_tensors
        spec, keys = ctx.spec, ctx.keys
        packed = dict(zip(keys, weights))
        need_x, need_aux = ctx.needs_input_grad[3], ctx.needs_input_grad[4]
        g_shared, g_aux, grads = heads_backward(spec, shared, aux, g_out.contiguous(),
                                                packed, need_aux)
        gx, *g_trunk = trunk.trunk_backward(spec, x, packed, acts, g_shared,
                                            need_gx=need_x)
        grads.update(zip(TRUNK_KEYS, g_trunk))
        need_w = ctx.needs_input_grad[5:]
        return (None, None, None, gx if need_x else None, g_aux if need_aux else None,
                *(grads[k] if need else None for k, need in zip(keys, need_w)))


def fused_field(spec: FieldSpec, x: torch.Tensor, aux: torch.Tensor,
                packed: dict) -> torch.Tensor:
    """(N, cx) points + (N, aux_w) aux -> (N, out_w) raw packed head outputs.

    Differentiable in x, aux and the packed tensors (through
    :class:`FusedField` when grad mode is on and an input requires grad;
    otherwise no residual is written). CPU tensors run the plain versions;
    CUDA tensors launch the kernels (K1 counted in ``LAUNCHES``) or raise.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_field: unsupported device {x.device}")
    keys = TRUNK_KEYS + spec.head_keys()
    weights = [packed[k] for k in keys]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, aux, *weights)):
        return FusedField.apply(spec, keys, packed, x, aux, *weights)
    return _forward(spec, x, aux, packed, resid=False)[0]

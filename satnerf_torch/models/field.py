"""Unified satellite-NeRF field (port of ``satnerf_tpu/models/field.py``).

One statically configured field family for the four variants (nerf, snerf,
satnerf, rs_semantic). Per point:

    enc(xyz) -> LxF trunk (skip-concat [enc_x, h], SIREN w0=30 first layer)
      -> sigma head        Linear(F,1)+softplus
      -> feats             Linear(F,F)                    (no nonlinearity)
      -> rgb head          Linear(F[+dir][+tau],fl)+nl+Linear(fl,3)+sigmoid,
                           then rgb*(1+2*pad)-pad
      -> sun-vis head      Linear(F+3,fl)+nl+2x[Linear(fl,fl)+nl]
                           +Linear(fl,1)+sigmoid          (snerf+)
      -> sky head          Linear(3,fl)+relu+Linear(fl,3)+sigmoid
      -> beta head         Linear(F+tau,fl)+nl+Linear(fl,1)+softplus (satnerf+)
      -> beta_s head       same shape, optional            (rs_semantic)
      -> semantic head     Linear(F[+tau],fl)+nl+Linear(fl,C)[+sigmoid]

``Field`` is an ``nn.Module`` whose state-dict keys are the reference's
(``fc_net.{2i}``, ``sigma_from_xyz.0``, ``feats_from_xyz``,
``rgb_from_xyzdir.{0,2}``, ``sun_v_net.{0,2,4,6}``, ``sky_color.{0,2}``,
``beta_from_xyz.{0,2}``, ``semantic_beta_from_xyz.{0,2}``,
``semantic_prediction.{0,2}``), with torch ``(out, in)`` weights.

``trunk_impl="xla"`` runs the layer-by-layer PyTorch path; ``"pallas"``
runs the reference's Pallas engines where the reference would run them: the
fused field (``ops/field_fused.py``, K1) for the configs it covers, else the
trunk-only kernel (``ops/trunk.py``, K3) followed by the layer-by-layer
heads (the ablation heads ``use_tj_instead_of_beta`` and
``use_separate_beta_for_s``). The kernels run on the card, their plain
versions on the CPU. The layer-by-layer trunk is the kernels' plain version
too, and counts its calls in ``PLAIN_CALLS`` on every device. All paths are
differentiable: under grad mode the kernels' inputs are packed with
differentiable ops, so their kernel backwards (K2 + K4, or K4) deliver
gradients to the ``nn.Linear`` parameters.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass, replace

import torch
from torch import nn
from torch.nn import functional as Fn

from satnerf_torch.core.encoding import encoded_size, positional_encoding
from satnerf_torch.ops import field_fused as ff
from satnerf_torch.ops import trunk
from satnerf_torch.ops.fastmath import SINE_ENGINES

VARIANTS = ("nerf", "snerf", "satnerf", "rs_semantic")

PLAIN_CALLS = 0  # layer-by-layer trunk calls (the plain version of K1/K3's trunk)


@dataclass(frozen=True)
class FieldConfig:
    """Static field architecture flags (same fields as the reference)."""

    variant: str = "satnerf"
    layers: int = 8
    feat: int = 512
    skips: tuple = (4,)
    siren: bool = True
    sin_impl: str = "poly"  # "poly" | "poly5" | "poly7f" | "exact"
    # "xla": layer-by-layer torch path; "pallas": the fused field kernel
    trunk_impl: str = "xla"
    # fused trunk backward: "recompute" rebuilds the pre-activations from x;
    # "stored" has the forward kernel write them (ops/trunk.py)
    trunk_bwd: str = "recompute"
    mapping: bool = False
    mapping_pos_n_freq: int = 10
    mapping_dir_n_freq: int = 4
    fc_use_full_features: bool = False
    t_embedding_tau: int = 4
    rgb_padding: float = 0.001
    n_classes: int = 5
    semantic_sigmoid: bool = True
    use_tj_for_s: bool = False
    use_tj_instead_of_beta: bool = False
    use_separate_beta_for_s: bool = False
    use_separate_tj_for_semantic: bool = False

    def __post_init__(self):
        assert self.variant in VARIANTS, f"unknown variant {self.variant}"
        assert self.sin_impl in ("poly", "poly5", "poly7f", "exact"), self.sin_impl
        assert self.trunk_impl in ("xla", "pallas"), self.trunk_impl
        assert self.trunk_bwd in ("recompute", "stored"), self.trunk_bwd

    @property
    def has_sun(self) -> bool:
        return self.variant in ("snerf", "satnerf", "rs_semantic")

    @property
    def has_beta(self) -> bool:
        return self.variant in ("satnerf", "rs_semantic")

    @property
    def has_semantic(self) -> bool:
        return self.variant == "rs_semantic"

    @property
    def use_dir(self) -> bool:
        return self.variant == "nerf"

    @property
    def feat_last(self) -> int:
        return self.feat if self.fc_use_full_features else self.feat // 2

    @property
    def xyz_in(self) -> int:
        return encoded_size(self.mapping_pos_n_freq, 3) if self.mapping else 3

    @property
    def dir_in(self) -> int:
        if not self.use_dir:
            return 0
        return encoded_size(self.mapping_dir_n_freq, 3) if self.mapping else 3


def _pallas_ok(cfg: FieldConfig) -> bool:
    return (
        cfg.trunk_impl == "pallas"
        and cfg.siren
        and cfg.sin_impl in ("poly", "poly5", "poly7f")
        and cfg.feat % 128 == 0
        and cfg.xyz_in <= 128
    )


def use_fused_field(cfg: FieldConfig) -> bool:
    """Where the reference runs its fused trunk+heads kernel."""
    return (
        _pallas_ok(cfg)
        and cfg.has_sun
        and cfg.feat_last % 128 == 0
        and not cfg.use_tj_instead_of_beta
        and not cfg.use_separate_beta_for_s
    )


def use_fused_trunk(cfg: FieldConfig) -> bool:
    """Where the reference runs its trunk-only kernel and the heads as XLA
    code (``_use_pallas_trunk`` outside ``_use_pallas_field``)."""
    return _pallas_ok(cfg) and not use_fused_field(cfg)


def fused_field_spec(cfg: FieldConfig) -> ff.FieldSpec:
    return ff.FieldSpec(
        layers=cfg.layers, feat=cfg.feat, skips=tuple(cfg.skips),
        c_in=cfg.xyz_in, fl=cfg.feat_last, tau=cfg.t_embedding_tau,
        n_classes=cfg.n_classes, has_beta=cfg.has_beta,
        has_semantic=cfg.has_semantic, use_tj_for_s=cfg.use_tj_for_s,
        sep_t_s=cfg.use_separate_tj_for_semantic, sin_mode=cfg.sin_impl,
        trunk_bwd=cfg.trunk_bwd,
    )


class _Activation(nn.Module):
    """Parameter-free activation slot (keeps the reference's odd indices)."""

    def __init__(self, cfg: FieldConfig, first: bool = False):
        super().__init__()
        self.cfg = cfg
        self.first = first

    def forward(self, x):
        return _act(self.cfg, x, self.first)


def _act(cfg: FieldConfig, x: torch.Tensor, first: bool = False):
    if cfg.siren:
        # sine arguments are phase-sensitive: evaluate in f32 even when the
        # products run in bf16, then return to the compute dtype
        w0 = 30.0 if first else 1.0
        if cfg.sin_impl != "exact":
            return SINE_ENGINES[cfg.sin_impl](w0 * x.to(torch.float32)).to(x.dtype)
        return torch.sin(w0 * x.to(torch.float32)).to(x.dtype)
    return torch.relu(x)


def _linear(layer: nn.Linear, x: torch.Tensor, dtype=None):
    w, b = layer.weight, layer.bias
    ct = dtype if dtype is not None else torch.promote_types(x.dtype, w.dtype)
    y = x.to(ct) @ w.to(ct).t()
    # bias in the RESULT dtype: the f32 head layers take bf16 features
    # against f32 weights, so y is f32 and the bias is not quantised
    return y + b.to(y.dtype)


class Field(nn.Module):
    """The field's weights, under the reference's state-dict names."""

    def __init__(self, cfg: FieldConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        F, fl, tau = cfg.feat, cfg.feat_last, cfg.t_embedding_tau
        fc = []
        for i in range(cfg.layers):
            if i == 0:
                fan_in = cfg.xyz_in
            elif i in cfg.skips:
                fan_in = F + cfg.xyz_in
            else:
                fan_in = F
            fc += [nn.Linear(fan_in, F), _Activation(cfg, first=(i == 0))]
        self.fc_net = nn.ModuleList(fc)
        self.sigma_from_xyz = nn.Sequential(nn.Linear(F, 1), nn.Softplus())
        self.feats_from_xyz = nn.Linear(F, F)
        rgb_in = F + cfg.dir_in
        if cfg.has_semantic and cfg.use_tj_instead_of_beta:
            rgb_in += tau
        self.rgb_from_xyzdir = nn.Sequential(
            nn.Linear(rgb_in, fl), _Activation(cfg), nn.Linear(fl, 3), nn.Sigmoid()
        )
        if cfg.has_sun:
            self.sun_v_net = nn.Sequential(
                nn.Linear(F + 3, fl), _Activation(cfg),
                nn.Linear(fl, fl), _Activation(cfg),
                nn.Linear(fl, fl), _Activation(cfg),
                nn.Linear(fl, 1), nn.Sigmoid(),
            )
            self.sky_color = nn.Sequential(
                nn.Linear(3, fl), nn.ReLU(), nn.Linear(fl, 3), nn.Sigmoid()
            )
        if cfg.has_beta:
            self.beta_from_xyz = nn.Sequential(
                nn.Linear(F + tau, fl), _Activation(cfg), nn.Linear(fl, 1),
                nn.Softplus(),
            )
        if cfg.has_semantic:
            if cfg.use_separate_beta_for_s:
                self.semantic_beta_from_xyz = nn.Sequential(
                    nn.Linear(F + tau, fl), _Activation(cfg), nn.Linear(fl, 1),
                    nn.Softplus(),
                )
            s_in = F + (tau if cfg.use_tj_for_s else 0)
            self.semantic_prediction = nn.Sequential(
                nn.Linear(s_in, fl), _Activation(cfg),
                nn.Linear(fl, cfg.n_classes),
                nn.Sigmoid() if cfg.semantic_sigmoid else nn.Identity(),
            )
        self._pack_cache: dict = {}
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Reference init: Linear weights and biases U(+-1/sqrt(fan_in));
        SIREN layers (trunk, sun-vis net) take U(+-sqrt(6/fan_in)) weights,
        U(+-1/fan_in) on the first layer of each."""

        def init(layer: nn.Linear, siren_first: bool | None = None):
            fan_in = layer.in_features
            default = 1.0 / math.sqrt(fan_in)
            wb = default
            if siren_first is not None and self.cfg.siren:
                wb = 1.0 / fan_in if siren_first else math.sqrt(6.0 / fan_in)
            for t, bound in ((layer.weight, wb), (layer.bias, default)):
                u = torch.rand(t.shape, generator=generator, dtype=torch.float32)
                t.copy_((2.0 * u - 1.0) * bound)

        for i in range(self.cfg.layers):
            init(self.fc_net[2 * i], siren_first=(i == 0))
        for name, module in self.named_children():
            if name == "fc_net":
                continue
            linears = [m for m in module.modules() if isinstance(m, nn.Linear)]
            for j, layer in enumerate(linears):
                init(layer, siren_first=(j == 0) if name == "sun_v_net" else None)

    def packed(self, dtype: torch.dtype, spec=None) -> dict:
        """The kernel's packed weights in ``dtype`` on this module's device
        (K1's whole field or K3's trunk, as this module's config runs),
        packed once and reused until a parameter changes. ``spec`` (a
        ``FieldSpec``) defaults to this module's config.

        The dict is a ``trunk.PackedWeights`` and must not be changed in
        place: it keeps the kernels' tensor-core layout of its tensors, made
        on first use. A changed parameter gives a new dict."""
        spec = replace(spec or fused_field_spec(self.cfg), heads_on=True)
        params = list(self.parameters())
        slot = (dtype, params[0].device)
        key = (spec, _param_key(params))
        hit = self._pack_cache.get(slot)
        if hit is None or hit[0] != key:
            with torch.no_grad():
                packed = _pack_fn(self.cfg)(self, spec, dtype)
            # detached: an f32 bias packs as the parameter itself
            hit = (key, trunk.PackedWeights({k: v.detach() for k, v in packed.items()}))
            self._pack_cache[slot] = hit
        return hit[1]

    def forward(self, xyz, view_dir=None, sun_d=None, t_emb=None, t_s_emb=None,
                compute_dtype=None, n_full=None) -> dict:
        return field_forward(self, self.cfg, xyz, view_dir, sun_d, t_emb,
                             t_s_emb, compute_dtype, n_full)


def field_forward(
    field: Field,
    cfg: FieldConfig,
    xyz,
    view_dir=None,
    sun_d=None,
    t_emb=None,
    t_s_emb=None,
    compute_dtype=None,
    n_full=None,
) -> dict:
    """Evaluate the field at a flat batch of points.

    Args:
        xyz: (N, 3) scene-normalised positions.
        view_dir: (N, 3) unit view directions (nerf only).
        sun_d: (N, 3) unit sun directions (snerf+).
        t_emb / t_s_emb: (N, tau) transient embedding rows (satnerf+).
        compute_dtype: e.g. torch.bfloat16 for the products; sines and the
            head outputs stay f32.
        n_full: if set, the rgb/sky/beta/beta_s/semantic heads run only on
            the first n_full points; sigma and sun_v cover all N (the
            renderer's solar-correction half reads nothing else).
    Returns:
        dict of f32 per-point outputs: rgb (M,3), sigma (N,), and sun_v
        (N,1), sky (M,3), beta (M,1), beta_s (M,1), semantic (M,C) by
        variant, where M = n_full or N.
    """
    global PLAIN_CALLS
    dt = compute_dtype
    enc_x = positional_encoding(xyz, cfg.mapping_pos_n_freq) if cfg.mapping else xyz
    if dt is not None:
        enc_x = enc_x.to(dt)

    nf = n_full if (n_full is not None and n_full < xyz.shape[0]) else None

    def _m(x):
        """Restrict a per-point input/feature to the heads-on prefix."""
        return x if (x is None or nf is None) else x[:nf]

    if use_fused_field(cfg):
        return _fused_field_forward(field, cfg, enc_x, sun_d, t_emb, t_s_emb,
                                    dt, nf)
    if _pallas_ok(cfg):
        # the trunk-only kernel K3, once over the main and solar-correction
        # points together; the heads run layer by layer below
        shared = _fused_trunk_forward(field, cfg, enc_x, dt)
    else:
        PLAIN_CALLS += 1
        h = enc_x
        for i in range(cfg.layers):
            if i in cfg.skips:
                h = torch.cat([enc_x, h], dim=-1)
            h = _act(cfg, _linear(field.fc_net[2 * i], h, dt), first=(i == 0))
        shared = h

    f32 = torch.float32
    sigma = Fn.softplus(_linear(field.sigma_from_xyz[0], shared).to(f32))
    feats = _linear(field.feats_from_xyz, shared, dt)
    out = {"sigma": sigma[..., 0]}

    feats_m, t_emb_m, t_s_emb_m = _m(feats), _m(t_emb), _m(t_s_emb)
    rgb_in = feats_m
    if cfg.use_dir:
        vd = _m(view_dir)
        enc_d = positional_encoding(vd, cfg.mapping_dir_n_freq) if cfg.mapping else vd
        rgb_in = torch.cat([rgb_in, enc_d.to(rgb_in.dtype)], dim=-1)
    if cfg.has_semantic and cfg.use_tj_instead_of_beta:
        rgb_in = torch.cat([rgb_in, t_emb_m.to(rgb_in.dtype)], dim=-1)
    rgb_net = field.rgb_from_xyzdir
    hr = _act(cfg, _linear(rgb_net[0], rgb_in, dt))
    rgb = torch.sigmoid(_linear(rgb_net[2], hr).to(f32))
    out["rgb"] = rgb * (1.0 + 2.0 * cfg.rgb_padding) - cfg.rgb_padding

    if cfg.has_sun:
        sv = torch.cat([feats, sun_d.to(feats.dtype)], dim=-1)
        sun_net = field.sun_v_net
        for j in (0, 2, 4):
            sv = _act(cfg, _linear(sun_net[j], sv, dt))
        out["sun_v"] = torch.sigmoid(_linear(sun_net[6], sv).to(f32))
        sk = torch.relu(_linear(field.sky_color[0], _m(sun_d).to(f32)))
        out["sky"] = torch.sigmoid(_linear(field.sky_color[2], sk).to(f32))

    if cfg.has_beta:
        bi = torch.cat([feats_m, t_emb_m.to(feats_m.dtype)], dim=-1)
        hb = _act(cfg, _linear(field.beta_from_xyz[0], bi, dt))
        out["beta"] = Fn.softplus(_linear(field.beta_from_xyz[2], hb).to(f32))

    if cfg.has_semantic:
        if cfg.use_separate_beta_for_s:
            bsi = t_s_emb_m if cfg.use_separate_tj_for_semantic else t_emb_m
            bi = torch.cat([feats_m, bsi.to(feats_m.dtype)], dim=-1)
            net = field.semantic_beta_from_xyz
            hb = _act(cfg, _linear(net[0], bi, dt))
            out["beta_s"] = Fn.softplus(_linear(net[2], hb).to(f32))
        si = feats_m
        if cfg.use_tj_for_s:
            st = t_s_emb_m if cfg.use_separate_tj_for_semantic else t_emb_m
            si = torch.cat([si, st.to(si.dtype)], dim=-1)
        net = field.semantic_prediction
        hs = _act(cfg, _linear(net[0], si, dt))
        logits = _linear(net[2], hs).to(f32)
        if cfg.semantic_sigmoid:
            logits = torch.sigmoid(logits)
        out["semantic"] = logits

    return out


def _pack_fn(cfg: FieldConfig):
    """The packing of the kernel ``cfg`` runs: K1's whole field or K3's trunk."""
    return ff.pack_field if use_fused_field(cfg) else trunk.pack_trunk


def _param_key(params) -> tuple:
    return tuple((p.data_ptr(), p._version) for p in params)


_SHARED_PACKS: dict | None = None  # the open shared_packing block's packed dicts


@contextmanager
def shared_packing():
    """Inside the block, the differentiable packing of a field's weights (per
    spec and dtype) is made once and shared by every call while the
    parameters are unchanged, so one autograd graph reads one packed dict
    (and K1/K3 prepare its tensor-core layout once): a training step opens
    it around each forward and backward, the backward's recomputations
    included. The packing records no tensor for its backward, so sharing it
    changes no gradient, only the order of its sums."""
    global _SHARED_PACKS
    outer, _SHARED_PACKS = _SHARED_PACKS, {}
    try:
        yield
    finally:
        _SHARED_PACKS = outer


def _packed_for_call(field: Field, spec, kdt) -> dict:
    """Differentiable packing when the parameters need gradients (shared
    inside :func:`shared_packing`), else the module's cached detached copy."""
    params = list(field.parameters())
    if torch.is_grad_enabled() and any(p.requires_grad for p in params):
        spec = replace(spec, heads_on=True)
        if _SHARED_PACKS is None:
            return _pack_fn(field.cfg)(field, spec, kdt)
        key = (id(field), spec, kdt, _param_key(params))
        hit = _SHARED_PACKS.get(key)
        if hit is None:
            hit = _SHARED_PACKS[key] = trunk.PackedWeights(_pack_fn(field.cfg)(field, spec, kdt))
        return hit
    return field.packed(kdt, spec)


def _fused_trunk_forward(field: Field, cfg: FieldConfig, enc_x, dt) -> torch.Tensor:
    """The trunk through K3 (``ops/trunk.py``): (N, F) in the compute dtype."""
    kdt = dt if dt is not None else torch.float32
    spec = fused_field_spec(cfg)
    packed = _packed_for_call(field, spec, kdt)
    return trunk.fused_trunk(spec, ff.pack_x(spec, enc_x, kdt), packed)


def _fused_field_forward(field: Field, cfg: FieldConfig, enc_x, sun_d, t_emb,
                         t_s_emb, dt, nf=None) -> dict:
    """The fused field + the column-wise nonlinearity epilogue; the output
    dict is identical to the layer-by-layer path's.

    With ``nf`` set, the first ``nf`` points run the all-heads variant and
    the remaining solar-correction points the sigma+sun_v-only variant."""
    kdt = dt if dt is not None else torch.float32
    spec = fused_field_spec(cfg)
    packed = _packed_for_call(field, spec, kdt)
    x = ff.pack_x(spec, enc_x, kdt)

    if nf is None:
        aux = ff.pack_aux(spec, sun_d, t_emb, t_s_emb, kdt)
        raw = raw_h = ff.fused_field(spec, x, aux, packed)
    else:
        spec_sc = replace(spec, heads_on=False)
        aux_sc = ff.pack_aux(spec_sc, sun_d[nf:], None, None, kdt)
        raw_sc = ff.fused_field(spec_sc, x[nf:], aux_sc, packed)
        if nf == 0:
            raw, raw_h = raw_sc, raw_sc[:0]
        else:
            aux = ff.pack_aux(
                spec, sun_d[:nf],
                None if t_emb is None else t_emb[:nf],
                None if t_s_emb is None else t_s_emb[:nf], kdt,
            )
            raw_h = ff.fused_field(spec, x[:nf], aux, packed)
            raw = torch.cat([raw_h, raw_sc], dim=0)

    out = {"sigma": Fn.softplus(raw[:, ff.COL_SIGMA])}
    rgb = torch.sigmoid(raw_h[:, ff.COL_RGB : ff.COL_RGB + 3])
    out["rgb"] = rgb * (1.0 + 2.0 * cfg.rgb_padding) - cfg.rgb_padding
    out["sun_v"] = torch.sigmoid(raw[:, ff.COL_SUN : ff.COL_SUN + 1])
    out["sky"] = torch.sigmoid(raw_h[:, ff.COL_SKY : ff.COL_SKY + 3])
    if cfg.has_beta:
        out["beta"] = Fn.softplus(raw_h[:, ff.COL_BETA : ff.COL_BETA + 1])
    if cfg.has_semantic:
        logits = raw_h[:, ff.COL_SEM : ff.COL_SEM + cfg.n_classes]
        if cfg.semantic_sigmoid:
            logits = torch.sigmoid(logits)
        out["semantic"] = logits
    return out

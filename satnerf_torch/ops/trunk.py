"""SIREN trunk backward (K4), both engines.

Port of ``satnerf_tpu/ops/pallas/trunk.py:_fused_trunk_bwd`` (bodies
``_bwd_kernel`` "recompute", ``_bwd_kernel_stored`` "stored" and the shared
reverse sweep ``_bwd_sweep``). ``trunk_backward`` launches the hand-written
CUDA kernels of ``csrc/trunk_bwd.cu`` for CUDA tensors and runs
:func:`trunk_backward_reference`, its plain PyTorch version, for CPU ones.
K3 (the trunk-only forward ``fused_trunk``) is not ported yet.

The trunk is ``h_0 = sin(w0 * (x @ W0 + b0))``,
``h_i = sin(h_{i-1} @ W_i [+ x @ Ws_i] + b_i)``. Given the gradient of
``h_{L-1}`` the backward returns, in the packed layout of
``ops/field_fused.py`` (``w0`` (cx, F), ``w_mid`` (L-1, F, F), ``w_skip``
(n_skip, cx, F), ``b`` (L, F)), the gradients of x and of every packed
tensor. "recompute" rebuilds the pre-activations from x; "stored" takes the
(L, N, F) pre-activations that the forward kernel wrote. As in the TPU
kernel, products take compute-dtype operands with f32 sums, every ``ga`` is
cast to the compute dtype before its products, the bias gradients sum the
f32 ``ga``, and the weight gradients are returned in the weights' dtype.
"""

from __future__ import annotations

import torch

from satnerf_torch.ops import _bwd
from satnerf_torch.ops.fastmath import COSINE_ENGINES, SIN_MODES, SINE_ENGINES

LAUNCHES = 0  # trunk_backward calls that launched the kernels (CUDA only)
PLAIN_CALLS = 0  # trunk_backward_reference calls
FEAT_WIDTHS = (512,)  # trunk widths the kernels are instantiated for
GX_WIDTHS = (64, 128)  # padded input widths of the gx launch (csrc/trunk_bwd.cu)


def dot_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32 product of compute-dtype operands (``preferred_element_type=f32``):
    bf16 operands are upcast before the product, so it sums in f32."""
    return a.to(torch.float32) @ w.to(torch.float32)


def _cast_grads(packed: dict, gw0, gwmid, gwskip, gb):
    return (gw0.to(packed["w0"].dtype), gwmid.to(packed["w_mid"].dtype),
            gwskip.to(packed["w_skip"].dtype), gb)


def trunk_backward_reference(spec, x, packed, acts, g_shared):
    """Plain PyTorch version of the trunk backward, step by step as
    ``_bwd_sweep``: (gx, gw0, gwmid, gwskip, gb)."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    sin, cos = SINE_ENGINES[spec.sin_mode], COSINE_ENGINES[spec.sin_mode]
    dt, L, f32 = x.dtype, spec.layers, torch.float32
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
        hs = [sin(spec.w0 * acts[0].to(f32)).to(dt)]
        hs += [sin(acts[i].to(f32)).to(dt) for i in range(1, L - 1)]

    g = g_shared.to(dt).to(f32)
    gwmid = torch.zeros(w_mid.shape, dtype=f32, device=x.device)
    gwskip = torch.zeros(w_skip.shape, dtype=f32, device=x.device)
    gb = torch.zeros(b.shape, dtype=f32, device=x.device)
    gx_skip = torch.zeros((x.shape[0], x.shape[1]), dtype=f32, device=x.device)
    for i in range(L - 1, 0, -1):
        ga = g * cos(pre[i].to(f32))
        ga_dt = ga.to(dt)
        gwmid[i - 1] = dot_f32(hs[i - 1].t(), ga_dt)
        gb[i] = ga.sum(0)
        if i in spec.skips:
            s = spec.skips.index(i)
            gwskip[s] = dot_f32(x.t(), ga_dt)
            gx_skip = gx_skip + dot_f32(ga_dt, w_skip[s].t())
        g = dot_f32(ga_dt, w_mid[i - 1].t())
    ga0 = g * cos(spec.w0 * pre[0].to(f32)) * spec.w0
    ga0_dt = ga0.to(dt)
    gw0 = dot_f32(x.t(), ga0_dt)
    gb[0] = ga0.sum(0)
    gx = (dot_f32(ga0_dt, w0.t()) + gx_skip).to(dt)
    return (gx, *_cast_grads(packed, gw0, gwmid, gwskip, gb))


def _trunk_backward_cuda(spec, x, packed, acts, g_shared, need_gx: bool):
    """The kernel path: row launches (recompute, reverse sweep, gx) and one
    reduction launch (csrc/trunk_bwd.cu)."""
    dt, L, F, n = x.dtype, spec.layers, spec.feat, x.shape[0]
    bf16 = dt == torch.bfloat16
    dev, f32 = x.device, torch.float32
    mode = SIN_MODES.index(spec.sin_mode)

    def row(**kw):
        _bwd.row_op("trunk_bwd", "trunk_bwd_row", dt, n, **kw)

    w0, w_mid, w_skip, b = (packed[k] for k in ("w0", "w_mid", "w_skip", "b"))
    scale = [spec.w0] + [1.0] * (L - 1)
    hs = torch.empty((max(L - 1, 1), n, F), dtype=dt, device=dev)  # h_0..h_{L-2}
    if acts is None:  # "recompute": the forward again, pre- and post-activations
        acts = torch.empty((L, n, F), dtype=dt, device=dev)
        for i in range(L):
            if i == 0:
                prods = [(x, w0)]
            else:
                prods = [(hs[i - 1], w_mid[i - 1])]
                if i in spec.skips:
                    prods.append((x, w_skip[spec.skips.index(i)]))
            row(width=F, prods=prods, bias=b[i], mode=_bwd.FWD_SINE, scale=scale[i],
                sin_mode=mode, out_dt=acts[i], out2_dt=hs[i] if i < L - 1 else None)
        write_h = False
    else:
        write_h = True  # "stored": the sweep rebuilds h_i = sin(a_i) as it goes

    ga = torch.empty((L, n, F), dtype=dt, device=dev)
    ga32 = torch.empty((L, n, F), dtype=f32, device=dev) if bf16 else ga
    g = g_shared.to(dt).contiguous()
    w_mid_t = [w_mid[i].t().contiguous() for i in range(L - 1)]
    for i in range(L - 1, -1, -1):
        top = i == L - 1
        row(width=F, prods=[] if top else [(ga[i + 1], w_mid_t[i])],
            add=g if top else None, pre=acts[i], mode=_bwd.BWD_SINE,
            scale=scale[i], sin_mode=mode, out_f32=ga32[i] if bf16 else None,
            out_dt=ga[i], out2_dt=hs[i] if (write_h and i < L - 1) else None)

    gx = None
    if need_gx:
        gw = _bwd.width_for(spec.cx, GX_WIDTHS)

        def t_pad(w):  # (cx, F) -> (F, gw), zero columns past cx
            return torch.nn.functional.pad(w.t(), (0, gw - spec.cx)).contiguous()

        prods = [(ga[0], t_pad(w0))]
        prods += [(ga[i], t_pad(w_skip[s])) for s, i in enumerate(spec.skips)]
        gx_pad = torch.empty((n, gw), dtype=dt, device=dev)
        row(width=gw, prods=prods, mode=_bwd.PLAIN, out_dt=gx_pad)
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
    if len(spec.skips) > _bwd.MAX_PRODS - 1:
        raise ValueError(f"trunk_backward: at most {_bwd.MAX_PRODS - 1} skips")
    if x.shape != (n, spec.cx) or not x.is_contiguous():
        raise ValueError(f"trunk_backward: x {tuple(x.shape)}, expected ({n}, {spec.cx})")
    if acts is not None and (acts.shape != (spec.layers, n, spec.feat)
                             or acts.dtype != x.dtype or not acts.is_contiguous()):
        raise ValueError(f"trunk_backward: acts {tuple(acts.shape)} {acts.dtype}")
    if g_shared.shape != (n, spec.feat) or g_shared.device != x.device:
        raise ValueError(f"trunk_backward: g_shared {tuple(g_shared.shape)}")
    out = _trunk_backward_cuda(spec, x, packed, acts, g_shared, need_gx)
    LAUNCHES += 1
    return out

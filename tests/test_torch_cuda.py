"""Each CUDA kernel of satnerf_torch against its plain PyTorch version, on
the card. Marked ``cuda``: without a GPU every test here skips.

The file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch (tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider -q
"""

import dataclasses

import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from satnerf_torch.device import disable_tf32

    disable_tf32()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads_on", [True, False])
@pytest.mark.parametrize("full_features", [False, True])
def test_cuda_field_kernel_matches_plain(cuda_device, dtype, heads_on, full_features,
                                         record_property):
    from satnerf_torch.core.encoding import positional_encoding
    from satnerf_torch.models.field import Field, FieldConfig, fused_field_spec
    from satnerf_torch.ops import field_fused as ff

    # both instantiated widths: (512, 256) and, with full features, (512, 512)
    cfg = FieldConfig(variant="rs_semantic", layers=4, feat=512, skips=(2,),
                      mapping=True, use_tj_for_s=True, trunk_impl="pallas",
                      fc_use_full_features=full_features)
    field = Field(cfg, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    spec = dataclasses.replace(fused_field_spec(cfg), heads_on=heads_on)
    g = torch.Generator().manual_seed(1)
    n = 1001
    enc = positional_encoding(torch.rand(n, 3, generator=g) * 2 - 1, 10).to(cuda_device)
    sun = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=1).to(cuda_device)
    te = torch.randn(n, 4, generator=g).to(cuda_device)
    with torch.no_grad():
        packed = field.packed(dtype)
        x = ff.pack_x(spec, enc, dtype)
        aux = ff.pack_aux(spec, sun, te, None, dtype)
        before = ff.LAUNCHES
        got = ff.fused_field(spec, x, aux, packed)
        torch.cuda.synchronize()
        assert ff.LAUNCHES == before + 1
        ref = ff.fused_field_reference(spec, x, aux, packed)
    # bf16: the same arithmetic on both sides; chip_smoke.py TOL_FIELD says why 2e-2
    tol = 5e-5 if dtype == torch.float32 else 2e-2
    err = float((got - ref).abs().max())
    record_property("max_abs_err", err)  # read with --junitxml
    assert err < tol


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(1001, 64), (77, 37)])
def test_cuda_composite_kernel_matches_plain(cuda_device, b, s):
    from satnerf_torch.ops import composite as comp

    g = torch.Generator().manual_seed(b)
    args = [torch.rand(b, s, generator=g) * 6 - 1,
            torch.sort(torch.rand(b, s, generator=g) * 2, dim=1).values,
            torch.rand(b, s, 3, generator=g), torch.rand(b, s, generator=g),
            torch.rand(b, 3, generator=g)]
    args = [a.to(cuda_device) for a in args]
    before = comp.LAUNCHES
    got = comp.composite(*args)
    torch.cuda.synchronize()
    assert comp.LAUNCHES == before + 1
    ref = comp.composite_reference(*args)
    for name, a, r, tol in zip(("w", "t", "depth", "rgb"), got, ref,
                               (1e-6, 1e-6, 1e-5, 1e-5)):
        assert float((a - r).abs().max()) <= tol, name

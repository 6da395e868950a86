"""Pipeline TOML -> ``FieldConfig`` and ``RenderConfig``.

Reads the handful of ``configs/pipelines/*.toml`` keys that the reference's
``step_config_from_main`` (satnerf_tpu/train/step.py) maps into the field
and render configs, with the reference's defaults for keys a file leaves
out (satnerf_tpu/configs.py pipeline classes).
"""

from __future__ import annotations

import tomllib

import torch

from satnerf_torch.models.field import FieldConfig
from satnerf_torch.render.renderer import RenderConfig

# pipeline name (or the reference's dotted path) -> field variant
_VARIANTS = {
    "nerf": "nerf",
    "snerf": "snerf",
    "satnerf": "satnerf",
    "rs_semantic": "rs_semantic",
    "baseline.pipelines.nerf.NerfPipeline": "nerf",
    "baseline.pipelines.snerf.SNerfPipeline": "snerf",
    "baseline.pipelines.satnerf.SatNeRFPipeline": "satnerf",
    "semantic.pipelines.rs_semantic.RSSemanticPipeline": "rs_semantic",
}


def load_pipeline_toml(fp: str) -> dict:
    with open(fp, "rb") as f:
        return tomllib.load(f)


def resolve_trunk_impl(impl: str, device) -> str:
    """``"auto"`` -> the fused kernel on CUDA, the layer-by-layer path
    elsewhere. The reference's rule encodes TPU measurements."""
    if impl != "auto":
        return impl
    return "pallas" if torch.device(device).type == "cuda" else "xla"


def render_config_from_pipeline(p: dict, n_classes: int = 5,
                                device="cuda") -> RenderConfig:
    """Pipeline-config dict (a parsed TOML) -> RenderConfig."""
    variant = _VARIANTS[p.get("pipeline", "nerf")]
    sin_impl = p.get("sin_impl", "poly")
    fcfg = FieldConfig(
        variant=variant,
        layers=p.get("fc_layers", 8),
        feat=p.get("fc_units", 512),
        skips=tuple(p.get("fc_skips", [4])),
        siren=p.get("activation_function", "siren") == "siren",
        sin_impl="poly" if sin_impl == "auto" else sin_impl,
        trunk_impl=resolve_trunk_impl(p.get("trunk_impl", "xla"), device),
        # the backward engine choice matters only to training (later slice)
        trunk_bwd="recompute" if p.get("trunk_bwd", "recompute") == "auto"
        else p.get("trunk_bwd", "recompute"),
        mapping=variant in ("nerf", "rs_semantic"),
        mapping_pos_n_freq=p.get("mapping_pos_n_freq", 10),
        mapping_dir_n_freq=p.get("mapping_dir_n_freq", 4),
        fc_use_full_features=p.get("fc_use_full_features", False),
        t_embedding_tau=p.get("t_embedding_tau", 4),
        n_classes=n_classes,
        semantic_sigmoid=p.get("semantic_activation_function", "sigmoid")
        == "sigmoid",
        use_tj_for_s=p.get("use_tj_for_s", False),
        use_tj_instead_of_beta=p.get("use_tj_instead_of_beta", False),
        use_separate_beta_for_s=p.get("use_separate_beta_for_s", False),
        use_separate_tj_for_semantic=p.get("use_separate_tj_for_semantic", False),
    )
    default_sc = 0.0 if variant == "nerf" else 0.05
    return RenderConfig(
        field=fcfg,
        n_samples=p.get("n_samples", 64),
        solar_correction=p.get("sc_lambda", default_sc) > 0,
        sc_stride=p.get("sc_stride", 1),
        compute_dtype=p.get("compute_dtype", "float32"),
        n_importance=p.get("n_importance", 0),
        use_fine_network=p.get("use_fine_network", False),
        remat_chunks=p.get("remat_chunks", 0),
    )


def load_render_config(fp: str, n_classes: int = 5, device="cuda",
                       **overrides) -> RenderConfig:
    """Read a pipeline TOML; ``overrides`` replace its keys first."""
    p = load_pipeline_toml(fp)
    p.update(overrides)
    return render_config_from_pipeline(p, n_classes=n_classes, device=device)

"""Pipeline TOML -> ``FieldConfig``, ``RenderConfig`` and ``StepConfig``.

Reads the ``configs/pipelines/*.toml`` keys that the reference's
``step_config_from_main`` (satnerf_tpu/train/step.py) maps into the field,
render and step configs, with the reference's defaults for keys a file
leaves out (satnerf_tpu/configs.py pipeline classes).
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
        # "auto" stays "recompute" until the card measures the trade (the
        # reference's rule, step.py:313-335, is a TPU measurement)
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


def step_config_from_pipeline(p: dict, steps_per_epoch: int, with_depth=None,
                              n_classes: int = 5, car_index: int = -1,
                              device="cuda"):
    """Pipeline-config dict -> ``StepConfig`` (``step_config_from_main``).

    ``with_depth=None`` takes ``depth_enabled`` (on by default for satnerf
    and rs_semantic); ``use_tj_instead_of_beta`` disables the uncertainty
    losses for good (first_beta_epoch = 10,000,000), as the reference does.
    """
    from satnerf_torch.train.step import StepConfig

    rcfg = render_config_from_pipeline(p, n_classes=n_classes, device=device)
    variant = rcfg.field.variant
    sat = variant in ("satnerf", "rs_semantic")
    depth = p.get("depth_enabled", sat) if with_depth is None else with_depth
    return StepConfig(
        render=rcfg,
        steps_per_epoch=steps_per_epoch,
        sc_lambda=p.get("sc_lambda", 0.0 if variant == "nerf" else 0.05),
        first_beta_epoch=(10_000_000 if p.get("use_tj_instead_of_beta", False)
                          else p.get("first_beta_epoch", 2)),
        beta_ramp_epochs=p.get("beta_ramp_epochs", 0.0),
        depth=bool(depth),
        ds_lambda=p.get("ds_lambda", 1000.0),
        ds_noweights=p.get("ds_noweights", False),
        semantic=variant == "rs_semantic",
        lambda_s=p.get("lambda_s", 0.04),
        car_index=car_index,
        ignore_car_index=p.get("ignore_car_index", True),
        use_beta_for_s=p.get("use_beta_for_s", False),
        detach_beta_for_s=p.get("detach_beta_for_s", False),
        use_car_reg_loss=p.get("use_car_reg_loss", False),
        car_reg_loss_start=p.get("car_reg_loss_start", 3),
        lambda_c=p.get("lambda_c", 0.1),
        grad_accum=p.get("grad_accum", 1),
    )

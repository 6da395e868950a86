"""Run and pipeline configs, and pipeline TOML -> ``FieldConfig``,
``RenderConfig`` and ``StepConfig``.

* ``RunConfig``, the four pipeline config classes and ``MainConfig`` have
  the reference's fields and defaults (satnerf_tpu/configs.py). They are
  dataclasses; construction coerces as the reference's lax validation
  does (an int where a float is declared becomes a float, a whole float or
  a numeric string where an int is declared becomes an int, 0/1 and
  "true"/"false" where a bool is declared become bools, anything else
  raises), and ``load_configs`` ignores keys a class does not declare.
* ``render_config_from_pipeline`` / ``step_config_from_pipeline`` read the
  ``configs/pipelines/*.toml`` keys that the reference's
  ``step_config_from_main`` (satnerf_tpu/train/step.py) maps into the
  field, render and step configs, with the reference's defaults for keys a
  file leaves out.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import time
import tomllib
from dataclasses import dataclass, field
from typing import Optional

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
    """On the card every engine name resolves to the kernels (``"pallas"``):
    there the layer-by-layer path would be the kernels' plain version, and a
    width the kernels are not built for raises at their launch. Off the card
    ``"auto"`` is the layer-by-layer path and ``"xla"``/``"pallas"`` stay as
    given. The reference's rule for ``"auto"`` encodes TPU measurements."""
    if torch.device(device).type == "cuda":
        return "pallas"
    return "xla" if impl == "auto" else impl


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


# --------------------------------------------------------------------------
# run and pipeline configs (satnerf_tpu/configs.py:42-235)
# --------------------------------------------------------------------------

_BOOL_STR = {"true": True, "t": True, "yes": True, "y": True, "on": True, "1": True,
             "false": False, "f": False, "no": False, "n": False, "off": False,
             "0": False}


def _coerce(name: str, kind: str, v):
    """The reference's lax coercion for the field types the configs declare."""
    if kind == "Optional[str]":
        if v is None:
            return None
        kind = "str"
    if kind == "float" and isinstance(v, (int, float, str)):
        return float(v)
    if kind == "int":
        if isinstance(v, (int, str)):
            return int(v)
        if isinstance(v, float) and v.is_integer():
            return int(v)
    if kind == "bool":
        if isinstance(v, bool):
            return v
        if isinstance(v, int) and v in (0, 1):
            return bool(v)
        if isinstance(v, str) and v.lower() in _BOOL_STR:
            return _BOOL_STR[v.lower()]
    if kind == "str" and isinstance(v, str):
        return v
    if kind == "list[int]" and isinstance(v, (list, tuple)):
        return [_coerce(name, "int", x) for x in v]
    raise ValueError(f"config field {name!r}: {v!r} is not a valid {kind}")


class _Config:
    """Coerces every field to its declared type on construction."""

    def __post_init__(self):
        for f in dataclasses.fields(self):
            setattr(self, f.name, _coerce(f.name, f.type, getattr(self, f.name)))

    @classmethod
    def field_names(cls) -> set:
        return {f.name for f in dataclasses.fields(cls)}

    def dump_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclass
class RunConfig(_Config):
    # training duration / cadence
    max_train_steps: int = 300000
    save_every_n_epochs: int = -1
    check_val_every_n_epoch: int = 1
    num_sanity_val_steps: int = 1
    shuffle_dataset: bool = True
    deterministic: bool = False
    seed: int = 42

    # device / precision
    data_parallel: int = 1  # > 1 is not ported yet (raises)
    # the reference's scan blocks; accepted so the same TOMLs load, no effect
    # (each step is its own call in the port)
    steps_per_dispatch: int = 1
    matmul_precision: str = "high"  # "highest" | "high" | "default"
    device_req_free: bool = True  # accepted so the same TOMLs load; no effect

    # resume
    resume_from_ckpoint: bool = False
    ckpoint_fp: Optional[str] = None
    # warm start: params only from a checkpoint (fresh optimizer, step 0);
    # a hierarchical target seeds its fine field from the source's coarse one
    warm_start_fp: Optional[str] = None

    run_name_postfix: str = ""
    experiment_category: str = ""

    # dataset
    dataset_name: str = ""
    dataset_limit_train_images: int = 0  # 0 = all

    # paths
    workspace_dp: str = ""
    cache_dp: str = ""
    datasets_dp: str = ""

    # populated at run start
    run_dp: str = ""
    run_name: str = ""

    @property
    def dataset_dp(self) -> str:
        return os.path.join(self.datasets_dp, self.dataset_name)


@dataclass
class NeRFConfig(_Config):
    pipeline: str = "nerf"
    precision: int = 32
    use_utm_coordinate_system: bool = False
    version: int = 1

    n_samples: int = 64
    use_fine_network: bool = False
    n_importance: int = 0
    render_chunk_size: int = 40960
    # validation render chunk in rays; 0 = auto (train/loop.py:val_chunk_rays)
    val_chunk_rays: int = 0
    batch_size: int = 1024
    learnrate: float = 5e-4
    noise_std: float = 0.0
    fc_units: int = 512
    fc_layers: int = 8
    fc_skips: list[int] = field(default_factory=lambda: [4])
    activation_function: str = "siren"
    sin_impl: str = "poly"
    trunk_impl: str = "xla"
    trunk_bwd: str = "recompute"
    mapping_pos_n_freq: int = 10
    mapping_dir_n_freq: int = 4
    fc_use_full_features: bool = False
    epoch_subsampling_activated: bool = False
    epoch_subsampling: float = 1.0
    lr_scheduler: str = "step"
    compute_dtype: str = "float32"
    grad_accum: int = 1
    remat_chunks: int = 0

    @property
    def variant(self) -> str:
        return "nerf"

    @property
    def use_mapping(self) -> bool:
        return self.variant in ("nerf", "rs_semantic")


@dataclass
class SNeRFConfig(NeRFConfig):
    pipeline: str = "snerf"
    sc_lambda: float = 0.05
    sc_stride: int = 1

    @property
    def variant(self) -> str:
        return "snerf"


@dataclass
class SatNeRFConfig(SNeRFConfig):
    pipeline: str = "satnerf"
    depth_enabled: bool = True
    depth_supervision_drop: float = 0.25
    ds_lambda: float = 1000.0
    first_beta_epoch: int = 2
    beta_ramp_epochs: float = 0.0
    t_embedding_vocab: int = 50
    t_embedding_tau: int = 4
    ds_noweights: bool = False

    @property
    def variant(self) -> str:
        return "satnerf"


@dataclass
class RSSemanticConfig(SatNeRFConfig):
    pipeline: str = "rs_semantic"
    semantic_dataset_type: str = "own"
    lambda_s: float = 0.04
    sparsity_n_images: int = -1
    semantic_activation_function: str = "sigmoid"
    use_tj_for_s: bool = False
    use_tj_instead_of_beta: bool = False
    use_beta_for_s: bool = False
    detach_beta_for_s: bool = False
    use_separate_beta_for_s: bool = False
    use_separate_tj_for_semantic: bool = False
    ignore_car_index: bool = True
    use_car_reg_loss: bool = False
    car_reg_loss_start: int = 3
    lambda_c: float = 0.1

    @property
    def variant(self) -> str:
        return "rs_semantic"


PIPELINE_REGISTRY: dict = {
    "nerf": NeRFConfig,
    "snerf": SNeRFConfig,
    "satnerf": SatNeRFConfig,
    "rs_semantic": RSSemanticConfig,
    "baseline.pipelines.nerf.NerfPipeline": NeRFConfig,
    "baseline.pipelines.snerf.SNerfPipeline": SNeRFConfig,
    "baseline.pipelines.satnerf.SatNeRFPipeline": SatNeRFConfig,
    "semantic.pipelines.rs_semantic.RSSemanticPipeline": RSSemanticConfig,
}


class MainConfig:
    """Bundle of run + pipeline configs."""

    def __init__(self, run: RunConfig, pipeline: NeRFConfig) -> None:
        self.run = run
        self.pipeline = pipeline

    def create_run_name(self) -> str:
        """Timestamped run name with the ablation postfix."""
        stamp = time.strftime("%Y-%m-%d_%H-%M-%S")
        name = f"{stamp}_{self.run.dataset_name}_{self.pipeline.variant}"
        name += _ablation_postfix(self.pipeline)
        if self.run.run_name_postfix:
            name += f"_{self.run.run_name_postfix}"
        return name

    def create_run_dp(self) -> str:
        if self.run.run_dp:  # already created (idempotent across CLI layers)
            return self.run.run_dp
        parts = [self.run.workspace_dp]
        if self.run.experiment_category:
            parts.append(f"_{self.run.experiment_category}")
        name = self.run.run_name or self.create_run_name()
        dp = os.path.join(*parts, name)
        # timestamped names have 1 s resolution: two runs never share a dir
        suffix = 0
        while True:
            try:
                os.makedirs(dp if not suffix else f"{dp}_{suffix}")
                break
            except FileExistsError:
                suffix += 1
        if suffix:
            name, dp = f"{name}_{suffix}", f"{dp}_{suffix}"
        self.run.run_name = name
        self.run.run_dp = dp
        return dp

    def dump(self, dp: str) -> None:
        """Persist both configs for a later reload."""
        os.makedirs(dp, exist_ok=True)
        write_toml(os.path.join(dp, "run.toml"), self.run.dump_dict())
        write_toml(os.path.join(dp, "pipeline.toml"), self.pipeline.dump_dict())


def _ablation_postfix(p: NeRFConfig) -> str:
    """The rs_semantic ablation flags, encoded into the run name."""
    if not isinstance(p, RSSemanticConfig):
        return ""
    bits = []
    if p.semantic_dataset_type != "own":
        bits.append(p.semantic_dataset_type)
    if p.sparsity_n_images > 0:
        bits.append(f"sparsity{p.sparsity_n_images}")
    if p.use_tj_for_s:
        bits.append("tj_for_s")
    if p.use_tj_instead_of_beta:
        bits.append("tj_instead_of_beta")
    if p.use_beta_for_s:
        bits.append("beta_for_s")
    if p.detach_beta_for_s:
        bits.append("detach_beta")
    if p.use_separate_beta_for_s:
        bits.append("beta_s")
    if p.use_separate_tj_for_semantic:
        bits.append("tj_s")
    if p.use_car_reg_loss:
        bits.append(f"car_reg{p.lambda_c}")
    return ("_" + "_".join(bits)) if bits else ""


read_toml = load_pipeline_toml


def _toml_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        escaped = (
            v.replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n")
            .replace("\r", "\\r")
            .replace("\t", "\\t")
        )
        return '"' + escaped + '"'
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    raise TypeError(f"cannot serialise {type(v)} to TOML")


def write_toml(fp: str, d: dict) -> None:
    lines = [f"{k} = {_toml_value(v)}" for k, v in d.items() if v is not None]
    with open(fp, "w") as f:
        f.write("\n".join(lines) + "\n")


_TEMPLATE = os.path.join(os.path.dirname(__file__), "run", "run_template.toml")


def load_configs(run_fp: str, pipeline_fp: str) -> MainConfig:
    """Load run + pipeline TOMLs; copy the run template where the run config
    is missing, and exit for the user to edit it."""
    from satnerf_torch.logger import logger

    if not os.path.isfile(run_fp):
        os.makedirs(os.path.dirname(run_fp) or ".", exist_ok=True)
        shutil.copy(_TEMPLATE, run_fp)
        logger.info("Config", f"No run config found; template copied to {run_fp}. "
                              "Edit it and re-run.")
        raise SystemExit(0)
    run_d = read_toml(run_fp)
    pipe_d = read_toml(pipeline_fp)
    pipe_name = pipe_d.get("pipeline", "satnerf")
    if pipe_name not in PIPELINE_REGISTRY:
        raise KeyError(f"unknown pipeline {pipe_name!r} in {pipeline_fp}; "
                       f"expected one of {'|'.join(sorted(PIPELINE_REGISTRY))}")
    cls = PIPELINE_REGISTRY[pipe_name]
    run_d = {k: v for k, v in run_d.items() if k in RunConfig.field_names()}
    pipe_d = {k: v for k, v in pipe_d.items() if k in cls.field_names()}
    return MainConfig(RunConfig(**run_d), cls(**pipe_d))


def load_configs_from_logs(run_dp: str) -> MainConfig:
    """Reload the configs persisted into a run dir."""
    cfg = load_configs(os.path.join(run_dp, "configs", "run.toml"),
                       os.path.join(run_dp, "configs", "pipeline.toml"))
    cfg.run.run_dp = run_dp
    return cfg


def adapt_configs_for_inference(cfg: MainConfig) -> MainConfig:
    """Inference-time tweaks: no resume, no sanity validation."""
    cfg.run.resume_from_ckpoint = False
    cfg.run.num_sanity_val_steps = 0
    return cfg

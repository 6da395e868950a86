"""Dataset-construction config (ref: data_prep/utils/dataset_config.py:82-147;
a copy of ``satnerf_tpu/data_prep/dataset_config.py`` without pydantic).

TOML file with a [general] section and [[steps]] entries; template bootstrap
copies dataset_template.toml on first run.

The three configs are dataclasses on ``satnerf_torch.configs._Config``:
keyword construction coerces each value to its declared type as pydantic
2's lax mode does (the run configs' helper), keys a config does not
declare are ignored, a missing one takes its default (a fresh list or dict
per instance), and a value pydantic rejects raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from dataclasses import dataclass, field
from typing import Optional

from satnerf_torch.configs import _Config, read_toml
from satnerf_torch.logger import logger


class _LaxConfig(_Config):
    """Keyword construction as pydantic's: undeclared keys ignored, a
    missing required one a ``ValueError``, then ``_Config``'s coercion."""

    def __init__(self, **kw):
        for f in dataclasses.fields(self):
            if f.name in kw:
                v = kw[f.name]
            elif f.default_factory is not dataclasses.MISSING:
                v = f.default_factory()
            elif f.default is not dataclasses.MISSING:
                v = f.default
            else:
                raise ValueError(f"{type(self).__name__}: field {f.name!r} is required")
            setattr(self, f.name, v)
        self.__post_init__()


@dataclass(init=False)
class StepConfig(_LaxConfig):
    file: str  # registry name or dotted module path with ProcessingStep
    enabled: bool = True
    from_dir: Optional[str] = None
    params: dict = field(default_factory=dict)


@dataclass(init=False)
class GeneralConfig(_LaxConfig):
    aoi_name: str = "JAX_068"
    lazy: bool = True
    # inputs (DFC2019 Track-3 distribution layout)
    dfc_rgb_dp: str = ""
    dfc_truth_dp: str = ""
    dfc_metadata_dp: str = ""
    ignore_masks_dp: Optional[str] = None
    semantic_masks_dp: Optional[str] = None
    # output dataset dir
    output_dp: str = ""
    zone_string: str = "17R"
    alt_min: Optional[float] = None
    alt_max: Optional[float] = None
    # splits: "predefined" (SatNeRF test files) | "random" | "fixed" | "custom"
    split_mode: str = "predefined"
    n_test: int = 2
    custom_test_files: list[str] = field(default_factory=list)
    seed: int = 0


@dataclass(init=False)
class DatasetConfig(_LaxConfig):
    general: GeneralConfig = field(default_factory=GeneralConfig)
    steps: list[StepConfig] = field(default_factory=list)


_TEMPLATE = os.path.join(os.path.dirname(__file__), "dataset_template.toml")


def load_dataset_config(cfg_fp: str) -> DatasetConfig:
    if not os.path.isfile(cfg_fp):
        os.makedirs(os.path.dirname(cfg_fp) or ".", exist_ok=True)
        shutil.copy(_TEMPLATE, cfg_fp)
        logger.info(
            "DataPrep",
            f"No dataset config found; template copied to {cfg_fp}. Edit and re-run.",
        )
        raise SystemExit(0)
    d = read_toml(cfg_fp)
    return DatasetConfig(
        general=GeneralConfig(**d.get("general", {})),
        steps=[StepConfig(**s) for s in d.get("steps", [])],
    )

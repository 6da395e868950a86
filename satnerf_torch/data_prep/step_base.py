"""Processing-step interface (ref: data_prep/processing/step_base.py:4-18; a
copy of ``satnerf_tpu/data_prep/step_base.py``)."""

from __future__ import annotations

import abc


class ProcessingStepBase(abc.ABC):
    def __init__(self, cfg, step_cfg: dict, state: dict) -> None:
        self.cfg = cfg
        self.step_cfg = step_cfg
        self.state = state

    @abc.abstractmethod
    def can_be_skipped(self, cfg, state) -> bool:
        ...

    @abc.abstractmethod
    def run(self, cfg, state) -> None:
        ...

    @abc.abstractmethod
    def update_state(self, cfg, state, has_run: bool) -> None:
        ...

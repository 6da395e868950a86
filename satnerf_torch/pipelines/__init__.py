"""Pipelines: datasets, normalization and step configs per variant."""

from satnerf_torch.pipelines.base import (  # noqa: F401
    NerfPipeline,
    Pipeline,
    RSSemanticPipeline,
    SatNeRFPipeline,
    SNerfPipeline,
    load_pipeline,
)

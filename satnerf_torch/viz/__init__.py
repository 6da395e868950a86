"""Visualization: TensorBoard image panels and GeoTIFF exports per
validation image, and the standalone re-run CLI (port of
``satnerf_tpu/viz``)."""

from satnerf_torch.viz import baseline_viz, experimental_viz, semantic_viz  # noqa: F401
from satnerf_torch.viz.visualize import (  # noqa: F401
    ImageVisualization,
    default_visualizers,
    run_all,
    run_visualizer,
)

"""Datasets: root.json-driven satellite scenes (RGB rays, depth tie-points,
semantic labels) plus the synthetic scene generator used by tests/bench."""

from satnerf_torch.datasets.satnerf_dataset import SatNeRFDataset  # noqa: F401
from satnerf_torch.datasets.depth_dataset import DepthDataset  # noqa: F401
from satnerf_torch.datasets.semantic_dataset import SemanticDataset  # noqa: F401

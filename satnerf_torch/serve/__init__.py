"""Serving: a render service over resident weights and its HTTP front end
(``python -m satnerf_torch.serve <run_dp>``)."""

from satnerf_torch.serve.service import RenderService  # noqa: F401
from satnerf_torch.serve.http_server import serve  # noqa: F401

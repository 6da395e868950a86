"""satnerf_torch: the PyTorch/CUDA port of satnerf_tpu for NVIDIA Hopper.

The JAX package ``satnerf_tpu`` is the reference; this package mirrors its
module names (``core/``, ``models/``, ``render/``, ``serve/``, ``train/``,
``ops/``, ``geo/``, ``io/``, ``datasets/``, ``eval/``, ``pipelines/``,
``run/``, ``viz/``) so the counterpart of each module is easy to find. It imports ``torch`` and
numpy only, never JAX or ``satnerf_tpu``.

Plain tensor code is PyTorch. Every Pallas kernel of the reference on the
ported path has a hand-written CUDA kernel for ``sm_90a`` under ``csrc/``,
built at first use by ``ops/_build.py`` and launched by the wrappers in
``ops/``. A wrapper given a CPU tensor runs the kernel's plain PyTorch
version; given a CUDA tensor it launches the kernel or raises.

Entry points take ``device=None``, meaning ``"cuda"``; without a GPU they
raise rather than fall back to the CPU (pass ``device="cpu"`` explicitly).
"""

from satnerf_torch.device import resolve_device

__all__ = ["resolve_device"]

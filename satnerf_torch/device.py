"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``. Raises when CUDA is asked for and absent: the
    entry points never fall back to the CPU on their own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "satnerf_torch: CUDA device requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them: every
    measurement is reported beside them, since a card set below its full
    power limit runs slower under load."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def disable_tf32() -> None:
    """Keep f32 matmuls and convolutions in full f32 on the card.

    The plain versions of the kernels are checked against the JAX package,
    which runs in full f32 on the CPU; TF32 keeps about three decimal digits
    and would swamp the stated tolerances.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

"""Core ray, encoding, sampling and compositing math (plain PyTorch)."""

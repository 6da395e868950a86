"""Evaluation: image metrics, DSM construction and the NCC-registered
altitude MAE (the rest of the eval battery is not ported yet)."""

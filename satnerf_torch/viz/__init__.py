"""Visualization helpers (only ``colormaps`` is ported so far)."""

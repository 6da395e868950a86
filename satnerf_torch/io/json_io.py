"""JSON helpers (ref: framework/util/file_utils.py:10-40)."""

from __future__ import annotations

import json
import os


def read_json(fp: str) -> dict:
    with open(fp) as f:
        return json.load(f)


def write_json(fp: str, d: dict) -> None:
    os.makedirs(os.path.dirname(fp) or ".", exist_ok=True)
    with open(fp, "w") as f:
        json.dump(d, f, indent=2)


def get_file_id(name: str) -> str:
    """'JAX_068_002_RGB.tif' -> 'JAX_068_002_RGB' (ref: file_utils.py)."""
    return os.path.splitext(os.path.basename(name))[0]

"""Dataset cache directories (ref: framework/cache_manager.py:4-34).

``<cache_dp>/<dataset_name>/<name>/``; existence = non-empty directory.
Cached artifacts are .npy ray tensors and normalization JSONs.
"""

from __future__ import annotations

import os


class CacheDir:
    def __init__(self, cache_dp: str, dataset_name: str) -> None:
        self.base = os.path.join(cache_dp, dataset_name)

    def dir_path(self, name: str) -> str:
        dp = os.path.join(self.base, name)
        os.makedirs(dp, exist_ok=True)
        return dp

    def exists(self, name: str) -> bool:
        dp = os.path.join(self.base, name)
        return os.path.isdir(dp) and len(os.listdir(dp)) > 0

"""Re-run the visualizer suite on a trained model over a whole split (port
of ``satnerf_tpu/viz/run_visualizer.py``; ref: semantic/run_visualizer.py:14-82
+ framework/visualize.py:198-313).

CLI: python -m satnerf_torch.viz.run_visualizer <run_dp> [output_dp]
     [--split test|train] [--epoch N] [--device cpu]

The device defaults to ``cuda`` and raises without a GPU.
"""

from __future__ import annotations

import sys

from satnerf_torch.viz.visualize import run_visualizer


def main(argv=None):
    from satnerf_torch.eval.eval_nerf import _parse

    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    args, kwargs = _parse(argv)
    run_visualizer(*args, **kwargs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Novel-view synthesis with relighting and re-dating.

Loads the example run into a persistent ``RenderService`` (the weights stay
on the device, packed once for the field kernel) and renders the same
viewpoint at noon and at dusk, and at another transient timestamp: the
paper's shadow and transient sweeps as three PNG files (written by
``satnerf_torch.io.png``, without Pillow).

    python -m satnerf_torch.examples.03_relight_views [--device cpu]
"""

import os

import numpy as np

from satnerf_torch.examples._common import example_workspace, get_or_train_run, parse_device


def _save(fp, rgb01):
    from satnerf_torch.io.png import save_png

    save_png((np.clip(rgb01, 0, 1) * 255).astype(np.uint8), fp)
    print(" wrote", fp)


def main(argv=None) -> int:
    device = parse_device(argv, __doc__)
    run_dp = get_or_train_run(device=device)
    from satnerf_torch.serve import RenderService

    svc = RenderService.from_run(run_dp, chunk=4096, device=device)
    view = svc.view_names()[0]
    out = os.path.join(example_workspace(), "relight")
    os.makedirs(out, exist_ok=True)

    noon = svc.render(view, sun_elevation=85.0)
    dusk = svc.render(view, sun_elevation=10.0, sun_azimuth=75.0)
    redate = svc.render(view, ts=1)

    _save(os.path.join(out, f"{view}_noon.png"), noon["rgb"])
    _save(os.path.join(out, f"{view}_dusk.png"), dusk["rgb"])
    _save(os.path.join(out, f"{view}_ts1.png"), redate["rgb"])
    print("stats:", svc.stats())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

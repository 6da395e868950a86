"""Run the full evaluation battery on the example run.

One checkpoint restore, each image rendered once, three consumers: PSNR/SSIM
and the DSM altitude MAE (NCC-registered), point-cloud export, and semantic
metrics (accuracy / mIoU / confusion). Results land as results.json files
plus gathered text tables, in the reference's eval output layout.

    python -m satnerf_torch.examples.02_eval_battery [--device cpu]
"""

import os

from satnerf_torch.examples._common import example_workspace, get_or_train_run, parse_device


def main(argv=None) -> int:
    device = parse_device(argv, __doc__)
    run_dp = get_or_train_run(device=device)
    out_dp = os.path.join(example_workspace(), "evalout")
    os.makedirs(out_dp, exist_ok=True)

    from satnerf_torch.eval.eval import eval_all

    eval_all(run_dp, out_dp, splits=("test",), device=device)
    print(f"\nresults under: {out_dp}")
    gathered = os.path.join(out_dp, "gathered.txt")
    if os.path.isfile(gathered):
        with open(gathered) as f:
            print(f.read())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

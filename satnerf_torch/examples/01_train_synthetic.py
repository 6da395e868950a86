"""Train the flagship RS-Semantic model on a generated synthetic scene.

No DFC2019 download needed: ``satnerf_torch.datasets.synthetic`` writes a
full root.json scene layout (multi-date RGB GeoTIFFs with RPC metadata, CLS
semantic labels, bundle-adjustment tie points) that exercises the whole
pipeline.

    python -m satnerf_torch.examples.01_train_synthetic [--device cpu]
"""

from satnerf_torch.examples._common import example_workspace, get_or_train_run, parse_device


def main(argv=None) -> int:
    device = parse_device(argv, __doc__)
    run_dp = get_or_train_run(device=device)
    print(f"\ntrained run: {run_dp}")
    print(f"workspace:   {example_workspace()}")
    print("next: python -m satnerf_torch.examples.02_eval_battery")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

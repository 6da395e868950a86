"""Round-trip interop with the PyTorch reference implementation.

Exports the example run's trained parameters to a reference-layout Lightning
checkpoint (``model_coarse.*``, ``model_t.weight``: the layout the
reference's own checkpoint loading reads; ``train/checkpoint.export_params``),
then reads it back with ``models/import_params.load_lightning_ckpt`` and
verifies that the round trip is exact. The same reader imports real
reference checkpoints.

    python -m satnerf_torch.examples.04_reference_interop [--device cpu]
"""

import os

import torch

from satnerf_torch.examples._common import example_workspace, get_or_train_run, parse_device


def main(argv=None) -> int:
    device = parse_device(argv, __doc__)
    run_dp = get_or_train_run(device=device)
    out_fp = os.path.join(example_workspace(), "exported_reference.ckpt")

    from satnerf_torch.eval.loader import load_run
    from satnerf_torch.models.import_params import load_lightning_ckpt
    from satnerf_torch.train.checkpoint import export_params

    pipeline, params, rcfg, step = load_run(run_dp, load_datasets=False, device=device)
    torch.save({"state_dict": export_params(params), "global_step": step}, out_fp)
    print(f"exported reference-format checkpoint: {out_fp}")

    reimported = load_lightning_ckpt(out_fp)
    missing = {k for k in params if params[k] is not None} - set(reimported)
    assert not missing, f"param groups not covered by the export: {missing}"
    n = 0
    for key, value in reimported.items():
        if isinstance(value, dict):  # a field's state dict
            ours = params[key].state_dict()
            assert list(ours) == list(value), f"{key}: tensor names differ"
            pairs = [(ours[k], value[k]) for k in value]
        else:  # an embedding table
            pairs = [(params[key], value)]
        for a, b in pairs:
            assert torch.equal(a.detach().cpu(), b), f"{key}: a tensor changed"
            n += 1
    print(f"round trip exact: {n} parameter tensors identical")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

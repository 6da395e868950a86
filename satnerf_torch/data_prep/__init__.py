"""Offline dataset construction of the port (a copy of
``satnerf_tpu/data_prep``): the DFC2019 adapter, cropping, the native
bundle adjustment, meta extraction, root.json and semantic masks, driven by
``python -m satnerf_torch.data_prep.create_dataset <cfg.toml>``, and the
annotation tooling (``prepare_annotations``, ``coco``). Host code in float64
numpy, as in the JAX package; no module here runs on the card."""

"""Quality and workflow tools over the port's host layer (counterparts of
the JAX package's root ``tools/``): train-and-evaluate with learning-curve
horizons, the production launcher, the eval-time sine swap, the tables
drawn from their results JSONs, and the four-scene user loop. Each is a
module with ``main(argv=None) -> int``:

    python -m satnerf_torch.tools.<name> ... [--device cpu]

``--device`` defaults to ``cuda`` and raises without a GPU
(``satnerf_torch.device.resolve_device``); the table tools read JSON only.

The measurement tools (``render_bench``, ``speed_of_light``, ``feed_rate``,
beside ``satnerf_torch.bench``) have no ``--device``: they measure the card
and raise without one. Their ``main`` returns the numbers it prints.
"""

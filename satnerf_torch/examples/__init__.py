"""Runnable examples over the port's public API (counterparts of the JAX
package's root ``examples/``), each run as a module from anywhere:

    python -m satnerf_torch.examples.01_train_synthetic [--device cpu]
    python -m satnerf_torch.examples.02_eval_battery [--device cpu]
    python -m satnerf_torch.examples.03_relight_views [--device cpu]
    python -m satnerf_torch.examples.04_reference_interop [--device cpu]

The first to run trains a small model on a generated scene; the others
reuse that run (``_common.get_or_train_run``). They run on the card unless
``--device cpu`` is given.
"""

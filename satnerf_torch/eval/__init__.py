"""Evaluation: image metrics, the DSM altitude MAE, semantic metrics, point
clouds, novel views, and the battery that runs them all over a trained run
(``python -m satnerf_torch.eval.eval <run_dp>``)."""

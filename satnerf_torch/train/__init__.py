"""Training: loss terms, LR schedules, train state, the train step, the
on-device ray store and samplers, checkpoints and the training loop."""

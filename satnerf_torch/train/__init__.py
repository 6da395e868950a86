"""Training: loss terms, LR schedules, train state and the train step."""

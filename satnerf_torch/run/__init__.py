"""Command-line entry points: training and resuming a run."""

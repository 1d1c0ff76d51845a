"""Training: the optimizer, the epoch loop and its artifacts."""

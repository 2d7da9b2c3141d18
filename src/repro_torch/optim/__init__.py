"""Port of repro.optim."""

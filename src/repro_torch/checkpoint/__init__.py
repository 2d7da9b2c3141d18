"""Port of repro.checkpoint."""

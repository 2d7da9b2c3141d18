"""Port of repro.core."""

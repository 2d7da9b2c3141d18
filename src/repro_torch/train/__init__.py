"""Port of repro.train."""

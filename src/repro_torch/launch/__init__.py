"""Port of repro.launch."""

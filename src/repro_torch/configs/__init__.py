"""Port of repro.configs."""

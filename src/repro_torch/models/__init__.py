"""Port of repro.models."""

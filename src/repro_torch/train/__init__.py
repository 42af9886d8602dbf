"""Training step and loop."""

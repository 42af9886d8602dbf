"""Checkpoints of the port's trees, in the reference's file format."""

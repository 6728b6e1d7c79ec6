"""Checkpoints and fault tolerance of the port."""

"""Checkpoints of the port (single device; re-sharding onto a mesh is not
ported)."""

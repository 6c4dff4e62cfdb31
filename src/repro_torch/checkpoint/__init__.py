"""Checkpointing of the port, mirroring ``repro.checkpoint``."""

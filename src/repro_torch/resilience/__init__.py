"""Resilient training driver of the port, mirroring ``repro.resilience``."""

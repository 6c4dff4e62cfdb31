"""Training step of the port, mirroring ``repro.train``."""

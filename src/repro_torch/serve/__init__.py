"""Paged serving engine mirroring ``repro.serve``."""

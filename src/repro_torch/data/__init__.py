"""Step-indexed data pipeline, mirroring ``repro.data``."""

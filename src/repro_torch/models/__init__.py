"""Plain-torch model code mirroring ``repro.models``."""

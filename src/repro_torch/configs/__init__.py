from repro_torch.configs.registry import (  # noqa: F401
    ARCH_IDS,
    get_arch,
    get_smoke,
)

from repro_torch.optim.optimizers import (  # noqa: F401
    adafactor,
    adamw,
    clip_by_global_norm,
    cosine_schedule,
    Optimizer,
)

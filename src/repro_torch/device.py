"""Device selection shared by the port's entry points.

Entry points run on the card. The CPU is used only when the caller asks
for it (``device="cpu"``), as the tests do; with no card and no explicit
request they raise instead of carrying on silently on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: repro_torch runs on the GPU "
                "unless the caller passes device='cpu'")
        return torch.device("cuda")
    return torch.device(device)

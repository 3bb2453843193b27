"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller names another device
(the CPU tests pass ``device="cpu"``). When no card is visible and the
caller did not ask for the CPU, they raise: nothing continues on the
CPU by itself.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' "
                           "to run on the CPU")
    return dev

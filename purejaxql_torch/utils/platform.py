"""Device choice for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU. A missing
GPU is an error, never a silent fall back to the CPU: a run that was meant
to measure the card must not quietly measure the host instead.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def device_type(device: Optional[Union[str, torch.device]]) -> str:
    """The device type ("cuda" or "cpu") a run asked for, without touching
    the CUDA runtime (config composition must not open a CUDA context)."""
    if device is None:
        return "cuda"
    return torch.device(device).type


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``. Raises when
    CUDA is asked for (explicitly or by default) and no GPU is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; the port runs on the GPU unless the "
            "CPU is asked for: pass device='cpu' (or DEVICE=cpu on the CLI)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev

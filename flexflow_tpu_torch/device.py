"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = DEFAULT_DEVICE) -> torch.device:
    """Turn a ``device`` argument into a :class:`torch.device`.

    ``None`` means the default, ``"cuda"``.  A CUDA device that is not
    present raises instead of carrying on quietly on the CPU: the CPU is
    used only when the caller asks for it with ``device="cpu"``."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {str(dev)!r}: expected 'cuda' or 'cpu'")
    return dev

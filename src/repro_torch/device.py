"""Device selection shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def fake_mode_active() -> bool:
    """Whether a ``FakeTensorMode`` is on the dispatch stack: tensors made
    now are shapes without storage (the dry run), and nothing can read a
    value back to the host."""
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The entry points run on ``cuda`` unless the caller asks for another
    device.  A CUDA request without a usable card raises: nothing quietly
    carries on on the CPU.  Under a ``FakeTensorMode`` a ``cuda`` request
    needs no card: it is card 0 (fake tensors of an index-free ``cuda``
    device cannot be copied to, as PyTorch asks the driver for the current
    card)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and fake_mode_active():
        return torch.device("cuda", 0 if dev.index is None else dev.index)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU")
    return dev

"""PyTorch / CUDA port of the STaMP serving path (``repro`` is the JAX
reference).  Modules mirror ``repro``'s layout: ``core`` (quantizers,
sequence transforms, STaMP linears, PTQ), ``kernels`` (hand-written Hopper
kernels beside their plain PyTorch versions), ``models``, ``serving``,
``launch``, ``configs`` and ``data``.  The package imports no JAX."""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]

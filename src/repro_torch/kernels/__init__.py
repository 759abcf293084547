"""The port's kernels (the twin of ``repro.kernels``): hand-written CUDA
kernels for Hopper beside their plain PyTorch versions.  The package exports
the reference's public entry points; they load lazily, so importing the
package builds nothing and imports no kernel module."""

from __future__ import annotations

import importlib

_EXPORTS = {
    "haar_dwt_seq": "repro_torch.kernels.ops",
    "int8_matmul": "repro_torch.kernels.ops",
    "quantize_pack": "repro_torch.kernels.ops",
    "stamp_decode_matmul": "repro_torch.kernels.ops",
    "stamp_quant_dual_matmul": "repro_torch.kernels.ops",
    "stamp_quant_grouped_matmul": "repro_torch.kernels.ops",
    "stamp_quant_matmul": "repro_torch.kernels.ops",
    "walsh_hadamard": "repro_torch.kernels.ops",
    "cache_decode_attention": "repro_torch.kernels.ops",
    "paged_ragged_attention": "repro_torch.kernels.ops",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(module), name)

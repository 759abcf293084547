"""Multi-level Haar DWT along the sequence: K9 ``haar_dwt_seq`` (CUDA
source: ``csrc/haar_dwt.cu``).

Replaces ``haar_dwt_pallas`` (``src/repro/kernels/haar_dwt.py``): the
forward L-level orthonormal Haar transform of ``(b, s, d)`` activations
along ``s``, or its inverse, all levels in one launch, in f32 with one cast
at the end.  The Pallas kernel keeps a ``(s, block_d)`` tile in VMEM; K9
needs no tile: a group of ``2^L`` consecutive rows is self-contained, so one
thread per (group, column) holds its group in registers (see the source
note).  Deeper transforms than ``MAX_LEVELS`` chain launches over the
approximation band in f32, each level the same operation on the same
values.

Bound on the H100: bytes — one read and one write of the activation.
"""

from __future__ import annotations

import torch

from repro_torch.core import transforms as T
from repro_torch.core.quant import recip32
from repro_torch.kernels import cuda

MAX_LEVELS = 5       # 2^5 f32 values a thread

_SIGNATURES = {"haar_dwt_seq": [
    cuda.VP, cuda.VP, cuda.INT, cuda.INT, cuda.INT, cuda.INT, cuda.INT,
    cuda.INT, cuda.FLT, cuda.VP]}


def haar_dwt_plain(x: torch.Tensor, levels: int = 3,
                   inverse: bool = False) -> torch.Tensor:
    """Plain version of K9 (the Pallas ``_dwt_kernel``): the port's Haar
    transform along the sequence on ``x.float()``, then one cast back."""
    fn = T.haar_idwt if inverse else T.haar_dwt
    return fn(x.float(), levels=levels, axis=-2).to(x.dtype)


def _launch(x: torch.Tensor, levels: int, inverse: bool) -> torch.Tensor:
    b, s, d = x.shape
    y = torch.empty_like(x)
    err = cuda.library("haar_dwt", _SIGNATURES).haar_dwt_seq(
        x.data_ptr(), y.data_ptr(), cuda.float_code(x.dtype, "K9"), b, s, d,
        levels, int(inverse), recip32(T.SQRT2), cuda.stream_ptr(x))
    cuda.check(err, "haar_dwt_seq")
    haar_dwt_seq.launches += 1
    return y


def _chain(x32: torch.Tensor, levels: int, inverse: bool) -> torch.Tensor:
    """``levels`` > ``MAX_LEVELS`` in f32: ``MAX_LEVELS`` over the whole
    sequence, the rest over the approximation band it leaves (for the
    inverse, the band's levels first)."""
    here = min(levels, MAX_LEVELS)
    if levels == here:
        return _launch(x32, levels, inverse)
    band = x32.shape[1] >> here
    if inverse:
        x32 = x32.clone()
        x32[:, :band] = _chain(x32[:, :band].contiguous(), levels - here,
                               True)
        return _launch(x32, here, True)
    y = _launch(x32, here, False)
    y[:, :band] = _chain(y[:, :band].contiguous(), levels - here, False)
    return y


def haar_dwt_seq(x: torch.Tensor, levels: int = 3,
                 inverse: bool = False) -> torch.Tensor:
    """K9.  ``x``: (b, s, d) f32, bf16 or f16 with ``s`` a multiple of
    ``2**levels``; returns the same shape and dtype."""
    if x.dim() != 3:
        raise ValueError(f"haar_dwt_seq takes (b, s, d), got {tuple(x.shape)}")
    if x.shape[1] % (1 << levels):
        raise ValueError(f"seq {x.shape[1]} not a multiple of "
                         f"2**levels={1 << levels}")
    if x.device.type == "cpu":
        return haar_dwt_plain(x, levels, inverse)
    cuda.float_code(x.dtype, "K9")
    cuda.require_cuda(x)
    if levels <= MAX_LEVELS:
        return _launch(x, levels, inverse)
    return _chain(x.float(), levels, inverse).to(x.dtype)


haar_dwt_seq.launches = 0

"""Gradient compression with error feedback, the port of
``repro.optim.compression``: per-tensor int8 codes with an f32 scale, and
the residual carried to the next step (``g_sent = Q(g + e); e ← (g + e) −
g_sent``, EF-SGD).

The scale is ``max(absmax · f32(1/127), 1e-12)``: the reference's step is
compiled, and XLA takes its ``absmax / 127.0`` as that product
(:func:`repro_torch.core.quant.div_const`); ``g / scale`` stays a true
division.  Codes round half to even and clip to ±127.
"""

from __future__ import annotations

import torch

from repro_torch import tree as TR
from repro_torch.core.quant import div_const


def _quantize_leaf(g: torch.Tensor) -> tuple:
    absmax = torch.amax(torch.abs(g)).float()
    scale = torch.clamp_min(div_const(absmax, 127.0), 1e-12)
    q = torch.clamp(torch.round(g.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def _compress_leaf(g: torch.Tensor, e: torch.Tensor) -> tuple:
    corrected = g.float() + e
    q, scale = _quantize_leaf(corrected)
    deq = q.float() * scale
    return q, scale, corrected - deq


def compress_gradients(grads, error) -> tuple:
    """``(int8 grads, scales, new error residuals)``, each a tree shaped
    as ``grads``."""
    out = [_compress_leaf(g, e)
           for g, e in zip(TR.leaves(grads), TR.leaves(error))]
    return tuple(TR.unflatten_like(grads, [o[i] for o in out])
                 for i in range(3))


def decompress_gradients(qs, scales, dtype=torch.float32):
    return TR.tree_map(lambda q, s: (q.float() * s).to(dtype), qs, scales)


def error_feedback_update(grads, error) -> tuple:
    """One quantize → dequantize round trip: the gradients a receiver
    would reconstruct, and the updated error state."""
    qs, scales, new_error = compress_gradients(grads, error)
    return decompress_gradients(qs, scales), new_error


def init_error_state(grads_shape):
    return TR.tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                             device=g.device), grads_shape)

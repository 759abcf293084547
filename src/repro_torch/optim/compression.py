"""Gradient compression with error feedback, the port of
``repro.optim.compression``: per-tensor int8 codes with an f32 scale, and
the residual carried to the next step (``g_sent = Q(g + e); e ← (g + e) −
g_sent``, EF-SGD).

The scale is ``max(absmax · f32(1/127), 1e-12)``: the reference's step is
compiled, and XLA takes its ``absmax / 127.0`` as that product
(:func:`repro_torch.core.quant.div_const`); ``g / scale`` stays a true
division.  Codes round half to even and clip to ±127.

Under a sharding policy the gradients and residuals are DTensors placed
as their parameters: each rank quantizes its blocks, and a leaf's
``absmax`` is its largest over every block (a max all-reduce), so the
scale, and with it every code, is the one-device run's (the reference's
per-tensor scale is GSPMD's global max).
"""

from __future__ import annotations

import torch

from repro_torch import sharding as SH
from repro_torch import tree as TR
from repro_torch.core.quant import div_const


def _quantize_leaf(g: torch.Tensor, absmax: torch.Tensor) -> tuple:
    scale = torch.clamp_min(div_const(absmax, 127.0), 1e-12)
    q = torch.clamp(torch.round(g.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def compress_gradients(grads, error) -> tuple:
    """``(int8 grads, scales, new error residuals)``, each a tree shaped
    as ``grads`` (codes and residuals placed as ``grads``)."""
    flat = TR.leaves(grads)
    corrected = [SH.local(g).float() + SH.local(e)
                 for g, e in zip(flat, TR.leaves(error))]
    absmax = SH.max_over_shards(
        [torch.amax(torch.abs(c)).float() for c in corrected], flat)
    out = []
    for g, c, a in zip(flat, corrected, absmax):
        q, scale = _quantize_leaf(c, a)
        out.append((SH.like(g, q), scale,
                    SH.like(g, c - q.float() * scale)))
    return tuple(TR.unflatten_like(grads, [o[i] for o in out])
                 for i in range(3))


def decompress_gradients(qs, scales, dtype=torch.float32):
    return TR.tree_map(
        lambda q, s: SH.like(q, (SH.local(q).float() * s).to(dtype)),
        qs, scales)


def error_feedback_update(grads, error) -> tuple:
    """One quantize → dequantize round trip: the gradients a receiver
    would reconstruct, and the updated error state."""
    qs, scales, new_error = compress_gradients(grads, error)
    return decompress_gradients(qs, scales), new_error


def init_error_state(grads_shape):
    return TR.tree_map(lambda g: torch.zeros_like(
        g, dtype=torch.float32, requires_grad=False), grads_shape)

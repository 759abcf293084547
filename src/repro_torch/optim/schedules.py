"""Learning-rate schedules: cosine and WSD (warmup–stable–decay), the
port of ``repro.optim.schedules``.

MiniCPM (arXiv:2404.06395) trains with WSD; the minicpm-2b config selects
it through ``ModelConfig.schedule = 'wsd'``.  Each schedule maps a step
(an int or a 0-dim tensor) to an f32 0-dim tensor on the step's device,
op for op as the reference's compiled step evaluates it: a division by a
constant is a product with the constant's f32 reciprocal
(:func:`repro_torch.core.quant.div_const`), and the warmup's two constants
fold into one.  What the compiled step does beyond that (its own ``cos``
and ``exp``, a multiply-add fused into one rounding) moves a value by a
few ulp.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from repro_torch.core.quant import div_const


def _f32_step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _warm_rate(peak_lr: float, warmup: int) -> float:
    """``peak_lr * step / warmup`` as the compiled step takes it: the two
    constants folded into one f32 quotient, then one product."""
    return float(np.float32(peak_lr) / np.float32(max(warmup, 1)))


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1) -> Callable:
    def fn(step):
        step = _f32_step(step)
        warm = step * _warm_rate(peak_lr, warmup)
        frac = torch.clamp(div_const(step - warmup, max(total - warmup, 1)),
                           0.0, 1.0)
        cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                         (1 + torch.cos(_const(math.pi, step) * frac)))
        return torch.where(step < warmup, warm, cos)
    return fn


def wsd_schedule(peak_lr: float, warmup: int, total: int,
                 decay_frac: float = 0.1, min_ratio: float = 0.01) -> Callable:
    """Warmup → stable plateau → sharp (exponential) decay over the final
    ``decay_frac`` of training (MiniCPM §4)."""
    decay_start = int(total * (1 - decay_frac))
    log_min = float(np.log(np.float32(min_ratio)))

    def fn(step):
        step = _f32_step(step)
        warm = step * _warm_rate(peak_lr, warmup)
        frac = torch.clamp(div_const(step - decay_start,
                                     max(total - decay_start, 1)), 0.0, 1.0)
        decay = peak_lr * torch.exp(_const(log_min, step) * frac)
        out = torch.where(step < warmup, warm, _const(peak_lr, step))
        return torch.where(step >= decay_start, decay, out)
    return fn


def make_schedule(kind: str, peak_lr: float, warmup: int, total: int
                  ) -> Callable:
    if kind == "wsd":
        return wsd_schedule(peak_lr, warmup, total)
    return cosine_schedule(peak_lr, warmup, total)

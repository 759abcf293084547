"""Figure 7 — feature transforms (rows) × sequence transforms (columns):
the gains are complementary, and DCT ≈ WHT ≈ DWT.  QuaRot's ±1 signs are
drawn once from a generator seeded with 2 (the reference draws its own
from ``jax.random``, so its quarot rows differ); ``signs`` overrides
them."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.feature_transforms import rademacher_signs
from repro_torch.core.stamp import StampConfig
from repro_torch.device import resolve_device
from repro_torch.paper.common import (QuantSetting, lvm_activations,
                                      quantized_linear_output, seeded_weight,
                                      sqnr_row, timed)

FEATURES = ["rtn", "smoothquant", "quarot"]
SEQUENCES = ["none", "dwt", "dct", "wht"]


def run(device=None, *, hw: tuple = (32, 32), d: int = 128, dout: int = 128,
        batch: int = 4, num_hi: int = 64,
        signs: Optional[torch.Tensor] = None) -> list:
    dev = resolve_device(device)
    x = lvm_activations(batch, hw, d, seed=0, device=dev)
    x[..., :3] *= 8.0                   # outlier channels
    w = seeded_weight(np.random.default_rng(0), d, dout, dev)
    if signs is None:
        signs = rademacher_signs(d, torch.Generator().manual_seed(2))
    ref = x @ w
    rows = []
    for feat in FEATURES:
        for seq in SEQUENCES:
            stamp = None
            if seq != "none":
                stamp = StampConfig(seq_transform=seq, num_hi_tokens=num_hi,
                                    skip_first_token=False)
            setting = QuantSetting(method=feat, stamp=stamp, act_bits=4,
                                   weight_bits=None)
            us, y = timed(lambda: quantized_linear_output(
                x, w, setting, signs=signs), device=dev)
            rows.append(sqnr_row(f"fig7/{feat}+{seq}", us, ref, y))
    return rows

"""Table 1 — STaMP improves LVM quantization.

W4A4 per-block (64) quantization of DiT-like latent-grid activations with
a few outlier channels; methods RTN, ViDiT-Q (SDCB) and SVDQuant, each
without and with STaMP (2-D DWT, 64 tokens at 8 bits).  Metric: the SQNR
of the layer output (the paper's image-space SQNR needs the diffusion
loop; the layer-level ordering is what is held)."""

from __future__ import annotations

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.paper.common import (QuantSetting, lvm_activations,
                                      quantized_linear_output, seeded_weight,
                                      sqnr_row, stamp_2d, timed)

METHODS = ["rtn", "vidit-q", "svdquant"]


def run(device=None, *, hw: tuple = (32, 32), d: int = 128, dout: int = 256,
        batch: int = 4, block: int = 64, num_hi: int = 64) -> list:
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x = lvm_activations(batch, hw, d, seed=0, device=dev)
    x_calib = lvm_activations(batch, hw, d, seed=1, device=dev)
    w = seeded_weight(rng, d, dout, dev)
    # a few outlier channels, as in real DiT activations
    x[..., :3] *= 8.0
    x_calib[..., :3] *= 8.0
    ref = x @ w
    rows = []
    for method in METHODS:
        for use_stamp in (False, True):
            setting = QuantSetting(
                method=method,
                stamp=stamp_2d(num_hi=num_hi, hw=hw) if use_stamp else None,
                act_bits=4, weight_bits=4, block=block)
            us, y = timed(lambda: quantized_linear_output(
                x, w, setting, x_calib=x_calib), device=dev)
            rows.append(sqnr_row(
                f"table1/{method}{'+stamp' if use_stamp else ''}", us, ref,
                y))
    return rows

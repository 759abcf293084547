"""The PTQ pipeline: calibrate → allocate → quantize → serve (the port of
``repro.core.ptq.calibrate_and_quantize``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import bitalloc
from repro_torch.core.calibration import SiteStats, toeplitz_fraction
from repro_torch.core.stamp import StampConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.serving.kvcache import KVCacheConfig


@dataclasses.dataclass
class PTQReport:
    num_hi: int
    avg_bits: float
    toeplitz_fraction: float
    energy_head_fraction: float     # energy in the first num_hi tokens
    sites: int


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16) if t.dtype == torch.float32 else t


@torch.no_grad()
def calibrate_and_quantize(params: dict, calib_batches: list,
                           cfg: ModelConfig, *, avg_budget: float = 4.125,
                           hi_bits: int = 8, lo_bits: int = 4,
                           transform: str = "dwt", levels: int = 3,
                           weight_bits: Optional[int] = 4, device=None
                           ) -> tuple[dict, lm.ServeConfig, PTQReport]:
    """Tap the embedding output and the final hidden states of each
    calibration batch, pick ``num_hi`` for the bit budget, and return
    serving params (bf16, large matmuls packed to int4 one layer at a time)
    with the matching ``ServeConfig``.  ``params`` must lie on ``device``
    (``cuda`` unless given)."""
    dev = resolve_device(device)
    stats: Optional[SiteStats] = None
    for batch in calib_batches:
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        taps = (lm._embed(params, tokens),
                lm.model_hidden(params, tokens, cfg))
        for tap in taps:
            tap = tap.float().cpu().numpy()
            if stats is None:
                stats = SiteStats.empty(tap.shape[-2], tap.shape[-1])
            stats.update(tap)
    if stats is None:
        raise ValueError("no calibration data")

    tf = toeplitz_fraction(stats.autocorr)
    order = np.sort(stats.energy_profile(transform, levels=levels))[::-1]
    num_hi = bitalloc.greedy_two_level(order, avg_budget, hi=hi_bits,
                                       lo=lo_bits)
    num_hi = max(1, min(num_hi, 64))
    head_frac = float(order[:num_hi].sum() / max(order.sum(), 1e-9))

    stamp = StampConfig(seq_transform=transform, levels=levels,
                        num_hi_tokens=num_hi, hi_bits=hi_bits,
                        lo_bits=lo_bits, skip_first_token=True)
    serve = lm.ServeConfig(
        stamp=stamp,
        kv=KVCacheConfig(quantized=True, num_hi=num_hi, hi_bits=hi_bits,
                         lo_bits=lo_bits),
        weight_bits=weight_bits)
    sparams = {k: _bf16(v) for k, v in params.items() if k != "layers"}
    sparams["layers"] = []
    for layer in params["layers"]:
        layer = {k: _bf16(v) for k, v in layer.items()}
        sparams["layers"].append(
            lm.quantize_weights_for_serving(layer, weight_bits)
            if weight_bits else layer)
    seq = stats.autocorr.shape[0]
    report = PTQReport(
        num_hi=num_hi,
        avg_bits=float((num_hi * hi_bits + (seq - num_hi) * lo_bits) / seq),
        toeplitz_fraction=tf, energy_head_fraction=head_frac, sites=2)
    return sparams, serve, report

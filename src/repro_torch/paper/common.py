"""Shared scaffolding of the paper runners — the port of
``benchmarks/common.py``: the quantization harness of one linear layer
under a feature-transform method with or without STaMP, DiT-like latent
activations, the two STaMP settings of the tables, and the timer.

The tables are reproduced structurally, as the reference's are: the same
quantization settings, transforms and metrics on synthetic activations
with the paper's autocorrelation structure (no pretrained weights).  What
they hold is the paper's orderings and deltas, not its absolute numbers.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import quant as Q
from repro_torch.core import transforms as T
from repro_torch.core.feature_transforms import (build_feature_transform,
                                                 svdquant_decompose)
from repro_torch.core.stamp import StampConfig, blockwise_mixed
from repro_torch.data.pipeline import ar_grid_features


def timed(fn: Callable, *args, device: torch.device,
          reps: int = 3) -> tuple:
    """``(µs per call, last output)`` over ``reps`` calls after one
    warm-up: CUDA events after a synchronize on the card,
    ``time.perf_counter`` on the CPU."""
    out = fn(*args)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        return (time.perf_counter() - t0) / reps * 1e6, out
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps * 1e3, out


@dataclasses.dataclass
class QuantSetting:
    """One table row: a feature-transform method × STaMP on / off."""

    method: str                  # rtn | smoothquant | quarot | vidit-q |
                                 # svdquant | flatquant
    stamp: Optional[StampConfig]
    act_bits: int = 4
    weight_bits: Optional[int] = 4
    block: Optional[int] = None  # per-block activation scales (Table 1: 64)


def quantized_linear_output(x: torch.Tensor, w: torch.Tensor,
                            setting: QuantSetting,
                            x_calib: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None,
                            signs: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """One linear layer ``x (b, s, d) @ w (d, dout)`` under ``setting``:
    the measurement core of Tables 1 and 4 and Figs. 4b and 7.  QuaRot's
    signs are ``signs``, or drawn from ``generator``."""
    d = x.shape[-1]
    spec = build_feature_transform(
        setting.method, d, x_calib=x_calib if x_calib is not None else x,
        w=w, generator=generator, signs=signs, bits=setting.act_bits,
        device=x.device)
    w_eff = spec.fold_into_weight(w)
    lowrank = None
    if setting.method == "svdquant":
        sq = svdquant_decompose(w_eff, rank=max(8, d // 16),
                                bits=setting.weight_bits or 4)
        wq = sq.residual.dequant(torch.float32)
        lowrank = (sq.l1, sq.l2)
    elif setting.weight_bits:
        wq = Q.rtn_quantize_weight(w_eff, bits=setting.weight_bits,
                                   axis=0).dequant(torch.float32)
    else:
        wq = w_eff
    tx = spec.apply_to_activation(x)
    s = x.shape[-2]
    st = setting.stamp
    kw = {}
    if st is not None:
        kw = dict(levels=st.resolved_levels(s), skip_first=st.skip_first_token,
                  hw=st.hw)
        tx = T.sequence_transform(tx, st.seq_transform, **kw)
        bits = st.bits_vector(s, device=x.device)
    else:
        bits = torch.full((s,), float(setting.act_bits), device=x.device)
    if setting.block:
        tq = blockwise_mixed(tx, bits, setting.block)
    else:
        tq = Q.fake_quant(tx, bits, axis=-1)
    y = tq @ wq
    if st is not None:
        y = T.inverse_sequence_transform(y, st.seq_transform, **kw)
    if lowrank is not None:
        l1, l2 = lowrank
        y = y + spec.apply_to_activation(x) @ (l1 @ l2)
    return y


def lvm_activations(batch: int = 4, hw: tuple = (32, 32), d: int = 128,
                    seed: int = 0, device=None) -> torch.Tensor:
    """DiT-like latent-grid activations (block-Toeplitz autocorrelation)."""
    return torch.from_numpy(ar_grid_features(batch, hw, d, rho=0.9,
                                             seed=seed)).to(device)


def seeded_weight(rng: np.random.Generator, din: int, dout: int,
                  device) -> torch.Tensor:
    """``normal(din, dout) / √din`` drawn as the reference's runners draw
    it (a float64 quotient, carried to f32)."""
    w = rng.normal(size=(din, dout)).astype(np.float32) / np.sqrt(din)
    return torch.from_numpy(w.astype(np.float32)).to(device)


def sqnr_row(name: str, us: float, ref: torch.Tensor,
             y: torch.Tensor) -> dict:
    return {"name": name, "us_per_call": us,
            "derived": f"sqnr_db={float(Q.sqnr_db(ref, y)):.2f}"}


def stamp_2d(num_hi: int = 64, hw: tuple = (32, 32)) -> StampConfig:
    return StampConfig(seq_transform="dwt2d", levels=3, num_hi_tokens=num_hi,
                       skip_first_token=False, hw=hw)


def stamp_1d(num_hi: int = 64, transform: str = "dwt") -> StampConfig:
    return StampConfig(seq_transform=transform, num_hi_tokens=num_hi,
                       skip_first_token=True)

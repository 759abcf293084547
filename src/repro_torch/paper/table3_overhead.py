"""Table 3 — the transforms' overhead on one DiT block forward
``silu(h·W1)·W2`` at the reference's (2, 1024, 512), with and without each
transform.

On the card the sequence Haar DWT (3 levels, and its inverse) runs through
K9 ``kernels.ops.haar_dwt_seq`` and the sequence and feature Walsh–Hadamard
transforms through K10 ``kernels.ops.walsh_hadamard`` (on the CPU their
plain versions); the GEMMs are ``torch.matmul``.  The latency overhead is
the timed rows' difference.

``flops_overhead_pct`` comes from an analytic count of the algorithm's
operations, counted as XLA's cost analysis counts them (one flop an
element for each elementwise operation, 2·M·N·K for a matrix product, 4
an element for silu: its logistic's negation, sum and quotient, and the
product):

* block: ``4·b·s·d·f`` for the two products (``f = 4d``) plus ``4·b·s·f``
  for silu;
* Haar DWT, forward or inverse, per level over a band of ``n`` rows:
  ``4·⌊n/2⌋·b·d`` (a sum, a difference and their two scalings per pair);
* WHT over ``p`` points: ``p·(log2 p + 1)`` per vector (a sum or a
  difference per point a stage, one scaling at the end), so ``b·d·s·(log2
  s + 1)`` along the sequence and ``b·s·d·(log2 d + 1)`` along the
  features.

XLA's count of the reference's compiled block is this one at the tests'
64 rows (within 0.01 points of the overhead); from 128 rows on it counts
the multi-level DWT higher, as its fused DWT program computes some
butterflies more than once.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.paper.common import lvm_activations, timed

TRANSFORMS = ("feat_hadamard", "seq_hadamard", "seq_dwt", "both")
LEVELS = 3


def block_forward(transform: str, x: torch.Tensor, w1: torch.Tensor,
                  w2: torch.Tensor, dwt=ops.haar_dwt_seq,
                  wht=ops.walsh_hadamard) -> torch.Tensor:
    """The block with ``transform`` around it; ``dwt(x, levels, inverse)``
    and ``wht(x, axis)`` are the kernels (or, to check them, their plain
    versions)."""
    h = x
    if transform in ("feat_hadamard", "both"):
        h = wht(h, -1)
    if transform in ("seq_dwt", "both"):
        h = dwt(h, LEVELS, False)
    if transform == "seq_hadamard":
        h = wht(h, -2)
    y = torch.nn.functional.silu(h @ w1) @ w2
    if transform in ("seq_dwt", "both"):
        y = dwt(y, LEVELS, True)
    if transform == "seq_hadamard":
        y = wht(y, -2)
    if transform in ("feat_hadamard", "both"):
        y = wht(y, -1)
    return y


def block_flops(transform: str, b: int, s: int, d: int) -> float:
    """The analytic count of the module docstring."""
    f = 4 * d
    flops = 4.0 * b * s * d * f + 4.0 * b * s * f
    dwt = 0
    n = s
    for _ in range(LEVELS):
        if n < 2:
            break
        dwt += 4 * (n // 2) * b * d
        n = (n + 1) // 2
    wht_seq = b * d * s * (math.log2(s) + 1)
    wht_feat = b * s * d * (math.log2(d) + 1)
    extra = {"none": 0, "feat_hadamard": 2 * wht_feat,
             "seq_hadamard": 2 * wht_seq, "seq_dwt": 2 * dwt,
             "both": 2 * (wht_feat + dwt)}[transform]
    return flops + extra


def block_weights(d: int, device) -> tuple:
    rng = np.random.default_rng(0)
    w1 = rng.normal(size=(d, 4 * d)).astype(np.float32)
    w2 = rng.normal(size=(4 * d, d)).astype(np.float32)
    return torch.from_numpy(w1).to(device), torch.from_numpy(w2).to(device)


def run(device=None, *, hw: tuple = (32, 32), d: int = 512,
        batch: int = 2) -> list:
    dev = resolve_device(device)
    x = lvm_activations(batch, hw, d, seed=0, device=dev)
    w1, w2 = block_weights(d, dev)
    s = hw[0] * hw[1]
    base = block_flops("none", batch, s, d)
    us, _ = timed(block_forward, "none", x, w1, w2, device=dev)
    rows = [{"name": "table3/baseline", "us_per_call": us,
             "derived": f"flops={base:.3e}"}]
    for tf in TRANSFORMS:
        us, _ = timed(block_forward, tf, x, w1, w2, device=dev)
        pct = (block_flops(tf, batch, s, d) - base) / base * 100
        rows.append({"name": f"table3/{tf}", "us_per_call": us,
                     "derived": f"flops_overhead_pct={pct:.2f}"})
    return rows

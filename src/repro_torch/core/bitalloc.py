"""Bit-width allocation (paper §3.3, Appendix A.2/A.3) — the port of
``repro.core.bitalloc``.

Given per-token energies ``e`` of the transformed activations, the optimal
real-valued allocation for a total of ``B`` bits is

    b_i* = log2 sqrt(e_i) + (B − Σ log2 sqrt(e_i)) / s        (Eq. 18)

Hardware takes a few integer widths, so STaMP's practical scheme is two
levels: the first ``num_hi`` tokens at ``hi`` bits, the rest at ``lo``."""

from __future__ import annotations

import math

import numpy as np
import torch

EPS = 1e-12


def _f32(v) -> torch.Tensor:
    """An f32 tensor of ``v`` (a tensor, an array of any strides or a
    list)."""
    if isinstance(v, torch.Tensor):
        return v.float()
    return torch.from_numpy(np.array(v, dtype=np.float32))


def optimal_bits(energies, total_bits: float) -> torch.Tensor:
    """Eq. 18, in f32.  ``log2`` is taken as ``log(e) / log(2)``, the
    form the reference's ``jnp.log2`` computes."""
    e = torch.clamp_min(_f32(energies), EPS)
    ln2 = torch.log(torch.tensor(2.0, device=e.device))
    log_sqrt_e = 0.5 * (torch.log(e) / ln2)
    s = e.shape[-1]
    c = (total_bits - log_sqrt_e.sum(dim=-1, keepdim=True)) / s
    return log_sqrt_e + c


def bound_value(energies, bits, d: int) -> torch.Tensor:
    """Theorem 1's bound ``d/2 · Σ e_i / (2^{b_i} − 1)²`` for an
    allocation (Fig. 2b)."""
    e = _f32(energies)
    denom = (2.0 ** _f32(bits).to(e.device) - 1.0) ** 2
    return 0.5 * d * torch.sum(e / torch.clamp_min(denom, EPS), dim=-1)


def two_level_bits(seq_len: int, num_hi: int, hi: int = 8, lo: int = 4,
                   device=None) -> torch.Tensor:
    """STaMP's practical two-precision vector."""
    idx = torch.arange(seq_len, device=device)
    return torch.where(idx < num_hi, float(hi), float(lo))


def greedy_two_level(energies: np.ndarray, avg_budget: float, hi: int = 8,
                     lo: int = 4) -> int:
    """The largest ``num_hi`` (tokens at ``hi`` bits) whose average width
    stays within ``avg_budget``; energies sorted descending."""
    s = len(energies)
    max_hi = int(np.floor(s * (avg_budget - lo) / (hi - lo)))
    return int(np.clip(max_hi, 0, s))


def integer_rounded_allocation(energies: np.ndarray, total_bits: int,
                               min_bits: int = 2,
                               max_bits: int = 8) -> np.ndarray:
    """Eq. 18 rounded to integers with a greedy repair of the budget:
    floor, then give each leftover bit to the token of the largest
    marginal bound reduction ``e_i / (2^b − 1)²`` (and take surplus bits
    from the smallest)."""
    e = np.maximum(np.asarray(energies, np.float64), EPS)
    b_star = optimal_bits(e, float(total_bits)).numpy()
    b = np.clip(np.floor(b_star), min_bits, max_bits).astype(np.int64)
    budget = total_bits - int(b.sum())
    gain = e / (2.0 ** b - 1) ** 2
    while budget > 0:
        i = int(np.argmax(np.where(b < max_bits, gain, -np.inf)))
        if not math.isfinite(gain[i]):
            break
        b[i] += 1
        budget -= 1
        gain[i] = e[i] / (2.0 ** b[i] - 1) ** 2
    while budget < 0:
        i = int(np.argmin(np.where(b > min_bits, gain, np.inf)))
        b[i] -= 1
        budget += 1
        gain[i] = e[i] / (2.0 ** b[i] - 1) ** 2
    return b

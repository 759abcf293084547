"""Two-level bit allocation (paper §3.3): the port of
``repro.core.bitalloc.greedy_two_level``."""

from __future__ import annotations

import numpy as np


def greedy_two_level(energies: np.ndarray, avg_budget: float, hi: int = 8,
                     lo: int = 4) -> int:
    """The largest ``num_hi`` (tokens at ``hi`` bits) whose average width
    stays within ``avg_budget``; energies sorted descending."""
    s = len(energies)
    max_hi = int(np.floor(s * (avg_budget - lo) / (hi - lo)))
    return int(np.clip(max_hi, 0, s))

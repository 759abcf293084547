"""Calibration (paper §3.2): the sequence autocorrelation ``S = E[X Xᵀ]``
of each quantization site, its KLT basis, the per-token energy under a
transform, and the calibration pass that turns them into a bit allocation
— the port of ``repro.core.calibration``.  The statistics are host-side
numpy, as the reference's."""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from repro_torch.core import bitalloc, transforms


@dataclasses.dataclass
class SiteStats:
    """Running statistics for one quantization site."""

    autocorr: np.ndarray       # (s, s) running mean of X Xᵀ
    act_absmax: np.ndarray     # (d,) running max |X| per feature
    count: int = 0

    @classmethod
    def empty(cls, seq_len: int, d: int) -> "SiteStats":
        return cls(np.zeros((seq_len, seq_len), np.float64),
                   np.zeros((d,), np.float32), 0)

    def update(self, x) -> None:
        """Accumulate one ``(b, s, d)`` batch (an array or a tensor)."""
        if isinstance(x, torch.Tensor):
            x = x.detach().float().cpu().numpy()
        xf = np.asarray(x, np.float32)
        b = xf.shape[0]
        s = np.einsum("bsd,btd->st", xf, xf) / xf.shape[0]
        self.autocorr = (self.autocorr * self.count + s * b) / \
            (self.count + b)
        self.act_absmax = np.maximum(
            self.act_absmax, np.abs(xf).reshape(-1, xf.shape[-1]).max(0))
        self.count += b

    def klt(self) -> np.ndarray:
        return transforms.klt_basis(self.autocorr)

    def energy_profile(self, kind: str, levels: int = 3,
                       hw: Optional[tuple] = None) -> np.ndarray:
        """Diagonal of ``L S Lᵀ`` — per-token energy under transform L
        (Eq. 9): the KLT's rows, or L built by transforming the
        identity."""
        s = self.autocorr.shape[0]
        if kind == "klt":
            l = torch.from_numpy(self.klt())
        else:
            eye = torch.eye(s, dtype=torch.float32)
            l = transforms.sequence_transform(eye[None], kind, axis=-2,
                                              levels=levels, hw=hw)[0]
        sa = torch.from_numpy(self.autocorr.astype(np.float32))
        return torch.einsum("is,st,it->i", l, sa, l).numpy()


def toeplitz_fraction(autocorr: np.ndarray) -> float:
    """Fraction of the autocorrelation's energy explained by its
    diagonal-mean Toeplitz projection (Fig. 3a)."""
    s = autocorr.shape[0]
    t = np.zeros_like(autocorr)
    for k in range(-s + 1, s):
        d = np.diagonal(autocorr, k)
        np.fill_diagonal(t[max(0, -k):, max(0, k):], d.mean())
    num = float((t ** 2).sum())
    den = float((autocorr ** 2).sum()) + 1e-12
    return num / den


@dataclasses.dataclass
class CalibrationResult:
    """Per-site calibration artifacts."""

    klt_bases: Dict[str, np.ndarray]
    energies: Dict[str, np.ndarray]
    act_absmax: Dict[str, np.ndarray]
    num_hi: Dict[str, int]


def calibrate(sites: Dict[str, Iterable], transform: str = "dwt",
              levels: int = 3, avg_budget: float = 4.125, hi: int = 8,
              lo: int = 4, compute_klt: bool = False) -> CalibrationResult:
    """The calibration pass over each site's ``(b, s, d)`` batches: the
    energy profile under ``transform``, the activations' absmax, the
    two-level ``num_hi`` for the bit budget, and (``compute_klt``) the KLT
    basis."""
    klts: Dict[str, np.ndarray] = {}
    energies: Dict[str, np.ndarray] = {}
    absmax: Dict[str, np.ndarray] = {}
    num_hi: Dict[str, int] = {}
    for name, batches in sites.items():
        stats: Optional[SiteStats] = None
        for x in batches:
            if stats is None:
                stats = SiteStats.empty(x.shape[-2], x.shape[-1])
            stats.update(x)
        if stats is None:
            raise ValueError(f"no calibration data for site {name}")
        e = stats.energy_profile(transform, levels=levels)
        energies[name] = e
        absmax[name] = stats.act_absmax
        num_hi[name] = bitalloc.greedy_two_level(np.sort(e)[::-1],
                                                 avg_budget, hi=hi, lo=lo)
        if compute_klt:
            klts[name] = stats.klt()
    return CalibrationResult(klts, energies, absmax, num_hi)

"""Calibration statistics (paper §3.2): sequence autocorrelation and the
per-token energy under a transform — the port of ``SiteStats`` and
``toeplitz_fraction`` of ``repro.core.calibration``.  Host-side numpy."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import transforms


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

    def update(self, x: np.ndarray) -> None:
        """Accumulate one ``(b, s, d)`` batch."""
        xf = np.asarray(x, np.float32)
        b = xf.shape[0]
        s = np.einsum("bsd,btd->st", xf, xf) / xf.shape[0]
        self.autocorr = (self.autocorr * self.count + s * b) / \
            (self.count + b)
        self.act_absmax = np.maximum(
            self.act_absmax, np.abs(xf).reshape(-1, xf.shape[-1]).max(0))
        self.count += b

    def energy_profile(self, kind: str, levels: int = 3) -> np.ndarray:
        """Diagonal of ``L S Lᵀ`` — per-token energy under transform L
        (Eq. 9), with L built by transforming the identity."""
        s = self.autocorr.shape[0]
        eye = torch.eye(s, dtype=torch.float32)
        l = transforms.sequence_transform(eye[None], kind, axis=-2,
                                          levels=levels)[0]
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

"""Figure 3 — autocorrelation structure and transformed-token energy.

Holds §3.2's chain of reasoning on AR(1) activations: the sequence
autocorrelation is close to Toeplitz, the KLT concentrates energy best,
the DCT approximates the KLT (Szegő), and the DWT concentrates it into
discrete levels that suit two-level mixed precision.  The statistics are
host-side numpy, as the reference's, whatever the device."""

from __future__ import annotations

import numpy as np

from repro_torch.core.calibration import SiteStats, toeplitz_fraction
from repro_torch.data.pipeline import ar_features
from repro_torch.device import resolve_device


def run(device=None, *, s: int = 256, d: int = 64, batch: int = 16,
        levels: int = 5, budgets: tuple = (8, 32, 64)) -> list:
    resolve_device(device)
    stats = SiteStats.empty(s, d)
    stats.update(ar_features((batch, s, d), rho=0.95, seed=0))
    rows = [{"name": "fig3/toeplitz_fraction", "us_per_call": 0.0,
             "derived": f"fraction={toeplitz_fraction(stats.autocorr):.4f}"}]
    for kind in ("klt", "dct", "wht", "dwt"):
        e = np.sort(stats.energy_profile(kind, levels=levels))[::-1]
        fr = {k: float(e[:k].sum() / e.sum()) for k in budgets}
        rows.append({"name": f"fig3/energy_{kind}", "us_per_call": 0.0,
                     "derived": ",".join(f"top{k}={fr[k]:.3f}"
                                         for k in budgets)})
    rows.append({"name": "fig3/energy_uniform", "us_per_call": 0.0,
                 "derived": ",".join(f"top{k}={k / s:.3f}"
                                     for k in budgets)})
    return rows

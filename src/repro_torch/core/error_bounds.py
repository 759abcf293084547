"""The paper's analytical error bounds (Eq. 3, Theorem 1, Appendix A.3) —
the port of ``repro.core.error_bounds``: the measured quantization error
never exceeds them, and energy concentration with mixed precision beats
the uniform scheme."""

from __future__ import annotations

import torch

from repro_torch.core import quant as Q


def _levels_sq(bits, device) -> torch.Tensor:
    n = 2.0 ** torch.as_tensor(bits, dtype=torch.float32, device=device) - 1.0
    return n ** 2


def eq3_bound(x: torch.Tensor, bits) -> torch.Tensor:
    """``Σ_i d/4 · range(x_i)² / (2^b − 1)²`` over the tokens of ``x``
    ``(…, s, d)`` (Eq. 3)."""
    d = x.shape[-1]
    rng = (x.amax(dim=-1) - x.amin(dim=-1)).float()
    return torch.sum(d / 4.0 * rng ** 2 / _levels_sq(bits, x.device))


def theorem1_bound(tx: torch.Tensor, bits) -> torch.Tensor:
    """``d/2 · Σ_i ‖(LX)_i‖² / (2^{b_i} − 1)²`` (Eq. 8) on the transformed
    activations ``tx = L X``."""
    d = tx.shape[-1]
    energy = torch.sum(tx.float() ** 2, dim=-1)
    return torch.sum(d / 2.0 * energy / _levels_sq(bits, tx.device))


def measured_error(x: torch.Tensor, bits, axis: int = -1) -> torch.Tensor:
    """The empirical ``‖Q(x) − x‖²`` with per-token min-max scales."""
    q = Q.fake_quant(x.float(), bits, axis=axis, out_dtype=torch.float32)
    return Q.quant_error(x, q)


def uniform_vs_concentrated(energies, avg_bits: float, d: int) -> tuple:
    """Appendix A.3: Theorem 1's bound for (a) uniform energy and bits and
    (b) the most concentrated energy under Eq. 18's bits.  Returns
    ``(uniform, concentrated)``; Jensen gives concentrated ≤ uniform."""
    e = torch.as_tensor(energies, dtype=torch.float32)
    s = e.shape[-1]
    uniform = d / 2.0 * s * (torch.sum(e) / s) / (2.0 ** (2 * avg_bits))
    log_e = torch.log2(torch.clamp_min(e, 1e-20))
    concentrated = d / 2.0 * s * 2.0 ** (torch.mean(log_e) - 2 * avg_bits)
    return uniform, concentrated

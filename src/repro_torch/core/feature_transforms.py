"""Feature-dimension transforms and the baselines the paper combines with
STaMP (Tables 1, 2 and 4, Fig. 7) — the port of
``repro.core.feature_transforms``.

* **Hadamard / QuaRot** — an orthogonal feature rotation ``X → X·R`` with
  ``R⁻¹`` folded into the weights; QuaRot's rotation carries random ±1
  signs.
* **SmoothQuant** — per-channel scale migration ``X → X·diag(s)⁻¹``,
  ``W → diag(s)·W``, ``s_j = max|X_j|^α / max|W_j|^{1−α}``.
* **ViDiT-Q SDCB** — SmoothQuant at the DiT-tuned α = 0.01.
* **SVDQuant** — ``W ≈ L₁L₂ + ΔW_q``: a float low-rank branch absorbs the
  outliers and the residual is RTN-quantized.
* **FlatQuant-lite** — a learned ``R = diag(e^θ)·H`` minimizing the layer
  output's quantization MSE with a few Adam steps through the
  straight-through rounding.

Feature transforms are right multiplications of the activation (the ``R``
of Eq. 4/6), so they compose with STaMP's left transform ``L``.  The
Hadamard matrices, the SVD and the Adam loop run as the reference's: the
first two in numpy, the loop step by step with the gradient from
autograd."""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core import quant as Q


@functools.lru_cache(maxsize=32)
def hadamard_matrix(d: int) -> np.ndarray:
    """Orthonormal Hadamard rotation for any ``d``: the Sylvester Hadamard
    for ``d = 2^k``, else ``H_{2^k} ⊗ I_m`` for ``d = 2^k · m``."""
    k, m = 0, d
    while m % 2 == 0:
        m //= 2
        k += 1
    h = np.array([[1.0]])
    for _ in range(k):
        h = np.block([[h, h], [h, -h]])
    h = h / np.sqrt(h.shape[0])
    if m > 1:
        h = np.kron(h, np.eye(m))
    return h.astype(np.float32)


def rademacher_signs(d: int, generator: torch.Generator) -> torch.Tensor:
    """``d`` random ±1 f32 signs drawn from ``generator``."""
    bits = torch.randint(0, 2, (d,), generator=generator,
                         device=generator.device)
    return (2 * bits - 1).float()


def random_hadamard(d: int, generator: Optional[torch.Generator] = None,
                    signs: Optional[torch.Tensor] = None,
                    device=None) -> torch.Tensor:
    """QuaRot's randomized Hadamard ``H · diag(±1)``: the signs are given,
    or drawn from ``generator``."""
    if signs is None:
        if generator is None:
            raise ValueError("random_hadamard needs a generator or signs")
        signs = rademacher_signs(d, generator)
    h = torch.tensor(hadamard_matrix(d), device=device or signs.device)
    return h * signs.to(h.device, torch.float32)[None, :]


def smoothquant_scales(act_absmax: torch.Tensor, w_absmax: torch.Tensor,
                       alpha: float = 0.5) -> torch.Tensor:
    """``s_j = max|X_j|^α / max|W_j|^{1−α}`` (SmoothQuant Eq. 4)."""
    a = torch.clamp_min(act_absmax, 1e-5) ** alpha
    w = torch.clamp_min(w_absmax, 1e-5) ** (1.0 - alpha)
    return a / w


def sdcb_scales(act_absmax: torch.Tensor, w_absmax: torch.Tensor,
                alpha: float = 0.01) -> torch.Tensor:
    """ViDiT-Q's static channel balancing: SmoothQuant at α = 0.01."""
    return smoothquant_scales(act_absmax, w_absmax, alpha=alpha)


@dataclasses.dataclass(frozen=True)
class SVDQuantWeight:
    """``W ≈ l1 @ l2 (float) + residual (int)``."""

    l1: torch.Tensor            # (d_in, r)
    l2: torch.Tensor            # (r, d_out)
    residual: Q.QuantizedWeight

    def dequant(self, dtype=torch.bfloat16) -> torch.Tensor:
        return (self.l1 @ self.l2).to(dtype) + self.residual.dequant(dtype)


def svdquant_decompose(w: torch.Tensor, rank: int = 32,
                       bits: int = 4) -> SVDQuantWeight:
    """The rank-``rank`` SVD branch (numpy, on the host) and the RTN codes
    of the residual, on ``w``'s device."""
    wf = w.detach().float().cpu().numpy()
    u, s, vt = np.linalg.svd(wf, full_matrices=False)
    l1 = u[:, :rank] * s[:rank][None, :]
    l2 = vt[:rank]
    resid = torch.from_numpy(wf - l1 @ l2).to(w.device)
    return SVDQuantWeight(l1=torch.from_numpy(l1).to(w.device),
                          l2=torch.from_numpy(l2).to(w.device),
                          residual=Q.rtn_quantize_weight(resid, bits=bits,
                                                         axis=0))


def flatquant_loss(theta: torch.Tensor, x_calib: torch.Tensor,
                   w: torch.Tensor, h: torch.Tensor, ref: torch.Tensor,
                   bits: int) -> torch.Tensor:
    """``mean‖Q(X R) R⁻¹ W − ref‖²`` (``ref = X W``) with ``R =
    diag(e^θ)·H`` and the analytic ``R⁻¹ = Hᵀ·diag(e^{−θ})``.  The range
    divides by the constant level count as the reference's compiled
    gradient does."""
    r = torch.exp(theta)[:, None] * h
    r_inv = h.T * torch.exp(-theta)[None, :]
    tq = Q.fake_quant(x_calib @ r, bits, axis=-1, compiled=True)
    y = (tq @ r_inv) @ w
    return torch.mean((y - ref) ** 2)


def flatquant_lite_fit(x_calib: torch.Tensor, w: torch.Tensor,
                       bits: int = 4, steps: int = 100,
                       lr: float = 1e-2) -> tuple:
    """Learn ``R = diag(e^θ)·H`` by ``steps`` of plain Adam on
    :func:`flatquant_loss` from θ = 0.  Returns ``(R, R⁻¹)``."""
    d = x_calib.shape[-1]
    h = torch.tensor(hadamard_matrix(d), device=x_calib.device)
    ref = x_calib @ w
    theta = torch.zeros((d,), dtype=torch.float32, device=x_calib.device)
    m = torch.zeros_like(theta)
    v = torch.zeros_like(theta)
    for t in range(1, steps + 1):
        th = theta.detach().requires_grad_(True)
        with torch.enable_grad():
            g, = torch.autograd.grad(
                flatquant_loss(th, x_calib, w, h, ref, bits), th)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mh = Q.fdiv(m, 1 - 0.9 ** t)
        vh = Q.fdiv(v, 1 - 0.999 ** t)
        theta = theta - lr * mh / (torch.sqrt(vh) + 1e-8)
    r = torch.exp(theta)[:, None] * h
    r_inv = h.T * torch.exp(-theta)[None, :]
    return r, r_inv


def fold_feature_transform(w: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``W' = R⁻¹ W = Rᵀ W`` for an orthonormal ``R``."""
    return r.T @ w


@dataclasses.dataclass(frozen=True)
class FeatureTransformSpec:
    """A calibrated feature transform: ``R`` (and SmoothQuant's scales)
    applied to activations, ``R⁻¹`` folded into the weight."""

    name: str
    r: Optional[torch.Tensor]        # None = identity
    r_inv: Optional[torch.Tensor]
    act_scale: Optional[torch.Tensor] = None

    def apply_to_activation(self, x: torch.Tensor) -> torch.Tensor:
        if self.act_scale is not None:
            x = x / self.act_scale.to(x.dtype)
        if self.r is not None:
            x = x @ self.r.to(x.dtype)
        return x

    def fold_into_weight(self, w: torch.Tensor) -> torch.Tensor:
        if self.r_inv is not None:
            w = self.r_inv.to(w.dtype) @ w
        if self.act_scale is not None:
            w = w * self.act_scale[:, None].to(w.dtype)
        return w


def build_feature_transform(name: str, d: int, *,
                            x_calib: Optional[torch.Tensor] = None,
                            w: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None,
                            signs: Optional[torch.Tensor] = None,
                            bits: int = 4,
                            device=None) -> FeatureTransformSpec:
    """Factory over the paper's feature-transform baselines.  QuaRot's
    signs come from ``signs`` or ``generator`` (neither: the plain
    Hadamard, as the reference without a key)."""
    if name in ("none", "identity", "rtn", "svdquant"):
        # SVDQuant is a weight decomposition: the caller adds its branch
        return FeatureTransformSpec(name, None, None)
    if name in ("hadamard", "quarot"):
        if signs is not None or generator is not None:
            r = random_hadamard(d, generator, signs, device=device)
        else:
            r = torch.tensor(hadamard_matrix(d), device=device)
        return FeatureTransformSpec(name, r, r.T)
    if name in ("smoothquant", "sdcb", "vidit-q"):
        if x_calib is None or w is None:
            raise ValueError(f"{name} needs x_calib and w")
        s = smoothquant_scales(x_calib.reshape(-1, d).abs().amax(dim=0),
                               w.abs().amax(dim=1),
                               alpha=0.5 if name == "smoothquant" else 0.01)
        return FeatureTransformSpec(name, None, None, act_scale=s)
    if name == "flatquant":
        if x_calib is None or w is None:
            raise ValueError(f"{name} needs x_calib and w")
        r, r_inv = flatquant_lite_fit(x_calib.reshape(-1, d), w, bits=bits)
        return FeatureTransformSpec(name, r, r_inv)
    raise ValueError(f"unknown feature transform {name!r}")

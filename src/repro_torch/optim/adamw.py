"""AdamW with decoupled weight decay and global-norm clipping, the port
of ``repro.optim.adamw``.

Plain functions over the port's parameter tree (``embed``,
``final_norm``, ``head``, ``layers`` as a list of dicts, ``encoder``).
The update follows the reference's ``upd`` op for op in f32: the
global-norm clip with ``max(gnorm, 1e-9)``, bias-corrected moments
``m / (1 − b1^step)`` and ``v / (1 − b2^step)``, ``delta = mh / (√vh +
eps) + wd·p`` and ``p − lr·delta`` cast back to the parameter's dtype.
(``torch.optim.AdamW`` is the same algebra with other roundings: it
decays ``p·(1 − lr·wd)`` before the Adam step and divides by ``√v / √bc2
+ eps``.)  Parameters and moments are updated in place, one leaf at a
time, so the update's temporaries stay one leaf's size.

Under a sharding policy (:mod:`repro_torch.sharding`) the leaves are
DTensors: the moments take their parameter's placement, the update runs
on each rank's blocks, and the global norm sums each element once (a
leaf's blocks over the mesh dims it is sharded on, one copy over those it
is replicated on).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch import sharding as SH
from repro_torch import tree as TR


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: Any = torch.float32
    schedule: Optional[Callable] = None


def adamw_init(params, cfg: AdamWConfig) -> dict:
    def zeros(p):
        return torch.zeros_like(p, dtype=cfg.moment_dtype,
                                requires_grad=False)
    step_dev = TR.leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=step_dev),
            "m": TR.tree_map(zeros, params),
            "v": TR.tree_map(zeros, params)}


def global_norm(tree) -> torch.Tensor:
    """``sqrt(Σ₁ + Σ₂ + …)``: each leaf's f32 sum of squares (over its
    blocks, when sharded), added in leaf order."""
    flat = TR.leaves(tree)
    sums = SH.sum_over_shards(
        [torch.sum(torch.square(SH.local(leaf).float())) for leaf in flat],
        flat)
    total = None
    for s in sums:
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, opt_state: dict, params, cfg: AdamWConfig) -> tuple:
    """One step: ``(params, opt_state, {"grad_norm", "lr"})``, the
    parameters and moments updated in place."""
    step = opt_state["step"] + 1
    lr = cfg.schedule(step) if cfg.schedule is not None else cfg.lr
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9),
                            1.0)
    stepf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)
    flat_p, flat_g, flat_m, flat_v = (
        [SH.local(t) for t in TR.leaves(tree)]
        for tree in (params, grads, opt_state["m"], opt_state["v"]))
    for g, m, v, p in zip(flat_g, flat_m, flat_v, flat_p):
        g = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        del g
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        delta += cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm,
                               "lr": torch.as_tensor(lr, dtype=torch.float32)}

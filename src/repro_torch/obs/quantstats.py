r"""STaMP quantization-health telemetry: per-site reductions on the device
(the port of ``repro.obs.quantstats``).

Four signals per STaMP site (qkv, wo, gate_up, wo_mlp, moe), each an O(1)
scalar reduced where the activation lives:

* **clip rate** — fraction of pre-clamp codes outside ``[0, 2^b-1]``.
  Min-max scales clip nothing by construction, so a rising clip rate means
  the scales no longer cover the transformed activations;
* **saturation count** — codes on the rails (0 or 2^b−1);
* **hi-token coverage** — fraction of (batch, token) rows quantized at
  ``hi_bits``;
* **scale dynamic range** — log2(max/min) of the per-token scales.

Collection protocol: an engine entry point (``lm.prefill``,
``lm.paged_prefill_chunk``, ``lm.paged_unified_step``, gated on
``ServeConfig.quant_telemetry``) calls :func:`begin`; each STaMP site calls
:func:`record` with its transformed activation (the fused sites recompute
the transform with plain PyTorch beside the kernels, which stay untouched);
the MoE router adds its load counters through :func:`record_extra`; the
entry point calls :func:`end` and returns the site dict beside its usual
outputs.  The port runs its layers in a Python loop, not a scan, so records
simply merge across layers (no drain / absorb).  The values stay 0-dim or
``(E,)`` tensors on the step's device until the engine moves them to the
host together with the step's token ids, in one transfer, and folds them
into its `MetricsRegistry` (:func:`summarize`).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import quant as Q

# keys combined by min/max; everything else sums across layers and steps
_SUM_KEYS = ("clipped", "saturated", "elems", "hi_tokens", "tokens")
_MIN_KEYS = ("scale_min",)
_MAX_KEYS = ("scale_max",)

_ACTIVE = False
_SITES: Optional[Dict[str, Dict[str, torch.Tensor]]] = None


def active() -> bool:
    return _ACTIVE


def begin() -> None:
    """Open a collection scope (entry points only)."""
    global _ACTIVE, _SITES
    _ACTIVE = True
    _SITES = {}


def end() -> Dict[str, Dict[str, torch.Tensor]]:
    """Close the scope and return everything collected."""
    global _ACTIVE, _SITES
    out = _SITES or {}
    _ACTIVE = False
    _SITES = None
    return out


def _merge(dst: Dict[str, Dict], site: str, stats: Dict) -> None:
    cur = dst.get(site)
    if cur is None:
        dst[site] = dict(stats)
        return
    for k, v in stats.items():
        if k in _MIN_KEYS:
            cur[k] = torch.minimum(cur[k], v)
        elif k in _MAX_KEYS:
            cur[k] = torch.maximum(cur[k], v)
        else:
            cur[k] = cur[k] + v


def record(site: Optional[str], tx: torch.Tensor, bits, hi_bits: int,
           scale=None, zp=None, split=None) -> None:
    """Record one site's transformed activation (no-op unless a scope is
    open).  A row-parallel block of a model ``split`` passes the whole
    rows' ``scale`` / ``zp``: its element counts (clipped, saturated,
    elements) are summed over the model ranks, and its per-row ones and
    scale extremes are every rank's alike — one device's stats."""
    if not _ACTIVE or site is None:
        return
    stats = site_stats(tx, bits, hi_bits, scale, zp)
    if split is not None:
        keys = ("clipped", "saturated", "elems")
        summed = split.reduce_out(torch.stack([stats[k] for k in keys]))
        stats.update(zip(keys, summed.unbind()))
    _merge(_SITES, site, stats)


def record_extra(site: str, stats: Dict[str, torch.Tensor]) -> None:
    """Record an arbitrary stats dict under a pseudo-site (the MoE
    router's ``expert_tokens`` / ``dropped_tokens`` / ``capacity_slots``);
    keys reduce by the same rules as the site stats."""
    if not _ACTIVE or site is None:
        return
    _merge(_SITES, site, {k: torch.as_tensor(v) for k, v in stats.items()})


def site_stats(tx: torch.Tensor, bits, hi_bits: int, scale=None,
               zp=None) -> Dict[str, torch.Tensor]:
    """The reductions for one transformed activation ``tx`` of shape
    ``(..., s, d)`` with per-token ``bits`` (``(s,)`` or a scalar).  Pass
    ``scale`` / ``zp`` to audit quantizer parameters chosen elsewhere; by
    default the quantizer's own per-token min-max parameters are
    recomputed.  Counts are f32, as the reference's are."""
    tx = tx.float()
    if scale is None:
        scale, zp = Q.minmax_scale_offset(tx, bits, axis=-1)
    n = Q.levels(bits, device=tx.device)
    if n.ndim:
        n = Q._align_token_axis(n, tx.ndim, -1)
    q_raw = torch.round(tx / scale) + zp
    # half a code of tolerance: an exact min / max lands on the rail to
    # within float error and must not count as clipped
    clipped = ((q_raw < -0.5) | (q_raw > n + 0.5)).sum()
    q = torch.minimum(torch.clamp_min(q_raw, 0.0), n)
    saturated = ((q <= 0.5) | (q >= n - 0.5)).sum()
    s = tx.shape[-2]
    tokens = float(np.prod(tx.shape[:-1]))         # (batch…, token) rows
    rows_per_seq = tokens / float(s)
    b = torch.as_tensor(bits, dtype=torch.float32, device=tx.device)
    if b.ndim:
        hi_tokens = (b >= float(hi_bits)).float().sum() * rows_per_seq
    else:
        hi_tokens = torch.tensor(tokens if float(b) >= float(hi_bits)
                                 else 0.0, device=tx.device)

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=tx.device)

    return {"clipped": f32(clipped), "saturated": f32(saturated),
            "elems": f32(float(tx.numel())), "hi_tokens": f32(hi_tokens),
            "tokens": f32(tokens), "scale_min": f32(scale.amin()),
            "scale_max": f32(scale.amax())}


def flatten(raw: Dict[str, Dict[str, torch.Tensor]]) -> tuple:
    """``raw``'s values as one f64 vector on their device (sites and keys
    in sorted order) plus the layout :func:`unflatten` needs: the engine
    appends the vector to the step's token ids and moves both to the host
    in one transfer."""
    layout, parts = [], []
    for site in sorted(raw):
        for key in sorted(raw[site]):
            v = raw[site][key]
            layout.append((site, key, tuple(v.shape)))
            parts.append(v.reshape(-1).double())
    return layout, parts


def unflatten(layout: list, values: np.ndarray) -> Dict[str, Dict]:
    """Inverse of :func:`flatten` on the host: numpy values per key."""
    out: Dict[str, Dict] = {}
    i = 0
    for site, key, shape in layout:
        n = int(np.prod(shape)) if shape else 1
        v = values[i:i + n]
        out.setdefault(site, {})[key] = v.reshape(shape) if shape \
            else np.float32(v[0])
        i += n
    return out


def summarize(raw: Dict[str, Dict]) -> Dict[str, Dict[str, float]]:
    """Host-side rates from the counts: per site ``clip_rate``,
    ``sat_rate``, ``hi_coverage``, ``scale_log2_range`` plus the raw counts
    as floats; pseudo-sites (no ``elems``) pass through, vectors as
    lists."""
    out: Dict[str, Dict[str, float]] = {}
    for site, stats in raw.items():
        if "elems" not in stats:
            passthru = {}
            for k, v in stats.items():
                a = np.asarray(v)
                passthru[k] = a.tolist() if a.ndim else float(a)
            out[site] = passthru
            continue
        vals = {k: float(np.asarray(v)) for k, v in stats.items()}
        elems = max(vals["elems"], 1.0)
        tokens = max(vals["tokens"], 1.0)
        smin = max(vals["scale_min"], 1e-30)
        out[site] = {
            **vals,
            "clip_rate": vals["clipped"] / elems,
            "sat_rate": vals["saturated"] / elems,
            "hi_coverage": vals["hi_tokens"] / tokens,
            "scale_log2_range": float(np.log2(max(vals["scale_max"], smin)
                                              / smin)),
        }
    return out

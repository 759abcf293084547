"""Table 4 — the per-site A4 ablation: STaMP helps at sequence-structured
sites and is about neutral at the pooled-conditioning site (cross-attn
``to_out``); QuaRot + STaMP is the strongest combination elsewhere.

Beside the accuracy rows, the deployment picture: the reference path
against the fused integer path at every model site the fused kernels
serve (QKV, out-proj on the head-split input, the gate/up pair, down, the
Mamba projections), at 256 rows.  On the card the fused path is K1 → K2
and, past 128 rows, the long-span chain with the span link; ``hbm_bytes``
is the reference's formula for each function's traffic (f32 activations),
not a measurement.

A site's activations are seeded with ``crc32(site) % 1000`` (the
reference seeds with Python's ``hash``, which changes from process to
process); QuaRot's signs are drawn once from a generator seeded with 3,
or given as ``signs``."""

from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.core.feature_transforms import rademacher_signs
from repro_torch.core.stamp import (StampConfig, prepare_linear,
                                    stamp_dual_linear, stamp_linear)
from repro_torch.device import resolve_device
from repro_torch.paper.common import (QuantSetting, lvm_activations,
                                      quantized_linear_output, seeded_weight,
                                      sqnr_row, timed)

SITES = ("attn1", "attn1.to_out", "ffn.up_proj", "attn2.to_out")
TRANSFORMS = ["identity", "quarot", "stamp", "quarot+stamp"]


def site_activations(site: str, d: int, batch: int = 4,
                     hw: tuple = (32, 32), device=None) -> torch.Tensor:
    """Sequence-structured sites get latent-grid activations; the
    pooled-conditioning site (every token exchanges with one text
    embedding) gets i.i.d. ones, which no sequence transform can
    concentrate."""
    if site == "attn2.to_out":
        rng = np.random.default_rng(3)
        x = rng.normal(size=(batch, hw[0] * hw[1], d)).astype(np.float32)
        return torch.from_numpy(x).to(device)
    return lvm_activations(batch, hw, d, seed=zlib.crc32(site.encode()) %
                           1000, device=device)


def stamp_site_bytes(s: int, din: int, dout: int,
                     dual: bool = False) -> tuple:
    """The reference's derived traffic of one STaMP linear site, f32
    activations: ``(reference path, fused path)`` bytes.  Reference: the
    transform and the fake quant each written and read back, the product
    written and read by the inverse, the inverse's write, X read, the int8
    codes read and the bf16 weight re-materialized (written and read);
    fused: X read once, the output written once, the codes streamed.  The
    dual site shares the activation's round trips, doubles each
    projection's and adds the silu·mul combine."""
    act, out = s * din * 4, s * dout * 4
    wbytes = din * dout
    wremat = 2 * din * dout * 2
    shared = 2 * act + 2 * act + act
    per_proj = 2 * out + out + wbytes + wremat
    if not dual:
        return shared + per_proj, act + out + wbytes
    ref = shared + 2 * per_proj + act + 2 * out + out
    return ref, act + out + 2 * wbytes


def fused_sites(device, s: int = 256, d: int = 128) -> list:
    """Every fused site run both ways on the same prepared int8 weights
    (the reference path on their dequantized copy): dicts of ``name``,
    ``us_ref`` / ``us_fused``, the outputs ``ref`` / ``fused`` and
    ``bytes`` (:func:`stamp_site_bytes`)."""
    rng = np.random.default_rng(7)
    nh = 4                               # out-proj head split (nh·hd = d)
    di = 2 * d                           # mamba inner dim
    cfg_ref = StampConfig(num_hi_tokens=64)
    cfg_fused = dataclasses.replace(cfg_ref, execution="fused")

    def acts(*shape):
        x = rng.normal(size=shape).astype(np.float32)
        return torch.from_numpy(x).to(device)

    def weight(k, n):
        w = rng.normal(size=(k, n)).astype(np.float32) * .05
        return torch.from_numpy(w).to(device)

    sites = {
        # name -> (din, dout, head-split input?, dual?)
        "attn.qkv": (d, 2 * d, False, False),
        "attn.out_proj": (d, d, True, False),
        "mlp.gate_up": (d, 2 * d, False, True),
        "mlp.down_proj": (2 * d, d, False, False),
        "mamba.in_proj": (d, 2 * di + 2 * 32 + 16, False, False),
        "mamba.out_proj": (di, d, False, False),
    }
    out = []
    for name, (din, dout, split, dual) in sites.items():
        x = acts(1, s, nh, din // nh) if split else acts(1, s, din)
        if dual:
            pg = prepare_linear(weight(din, dout))
            pu = prepare_linear(weight(din, dout))
            us_ref, y_ref = timed(lambda: stamp_dual_linear(
                x, pg.dequant(torch.float32), pu.dequant(torch.float32),
                cfg_ref), device=device, reps=2)
            us_fused, y_fused = timed(lambda: stamp_dual_linear(
                x, None, None, cfg_fused, prepared_gate=pg,
                prepared_up=pu), device=device, reps=2)
        else:
            prep = prepare_linear(weight(din, dout))
            us_ref, y_ref = timed(lambda: stamp_linear(
                x, prep.dequant(torch.float32), None, cfg_ref,
                merge_heads=split), device=device, reps=2)
            us_fused, y_fused = timed(lambda: stamp_linear(
                x, None, None, cfg_fused, prepared=prep,
                merge_heads=split), device=device, reps=2)
        out.append(dict(name=name, us_ref=us_ref, us_fused=us_fused,
                        ref=y_ref, fused=y_fused,
                        bytes=stamp_site_bytes(s, din, dout, dual=dual)))
    return out


def fused_site_rows(sites: list) -> list:
    """The rows of :func:`fused_sites`' results."""
    rows = []
    for site in sites:
        ref_b, fused_b = site["bytes"]
        rows.append({"name": f"kernels/site/{site['name']}/reference",
                     "us_per_call": site["us_ref"],
                     "derived": f"hbm_bytes={ref_b}"})
        rows.append({"name": f"kernels/site/{site['name']}/fused",
                     "us_per_call": site["us_fused"],
                     "derived": (f"hbm_bytes={fused_b},"
                                 f"hbm_savings={ref_b / fused_b:.2f}x")})
    return rows


def ablation_rows(device=None, *, hw: tuple = (32, 32), d: int = 128,
                  dout: int = 128, batch: int = 4, num_hi: int = 64,
                  signs: Optional[torch.Tensor] = None) -> list:
    """The per-site A4 ablation's rows."""
    dev = resolve_device(device)
    w = seeded_weight(np.random.default_rng(1), d, dout, dev)
    if signs is None:
        signs = rademacher_signs(d, torch.Generator().manual_seed(3))
    rows = []
    for site in SITES:
        x = site_activations(site, d, batch, hw, dev)
        ref = x @ w
        for tf in TRANSFORMS:
            stamp = None
            if "stamp" in tf:
                stamp = StampConfig(seq_transform="dwt2d", levels=3, hw=hw,
                                    num_hi_tokens=num_hi,
                                    skip_first_token=False)
            setting = QuantSetting(
                method="quarot" if "quarot" in tf else "rtn", stamp=stamp,
                act_bits=4, weight_bits=None)
            us, y = timed(lambda: quantized_linear_output(
                x, w, setting, signs=signs), device=dev)
            rows.append(sqnr_row(f"table4/{site}/{tf}", us, ref, y))
    return rows


def run(device=None, *, hw: tuple = (32, 32), d: int = 128,
        dout: int = 128, batch: int = 4, num_hi: int = 64,
        fused_s: int = 256, fused_d: int = 128,
        signs: Optional[torch.Tensor] = None) -> list:
    dev = resolve_device(device)
    return (ablation_rows(dev, hw=hw, d=d, dout=dout, batch=batch,
                          num_hi=num_hi, signs=signs) +
            fused_site_rows(fused_sites(dev, fused_s, fused_d)))

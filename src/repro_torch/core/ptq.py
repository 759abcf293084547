"""The PTQ pipeline: calibrate → allocate → quantize → serve (the port of
``repro.core.ptq.calibrate_and_quantize``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import bitalloc
from repro_torch.core.calibration import SiteStats, toeplitz_fraction
from repro_torch.core.stamp import StampConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.serving.kvcache import KVCacheConfig


@dataclasses.dataclass
class PTQReport:
    num_hi: int
    avg_bits: float
    toeplitz_fraction: float
    energy_head_fraction: float     # energy in the first num_hi tokens
    sites: int


@torch.no_grad()
def capture_block_inputs(params: dict, batch, cfg: ModelConfig) -> list:
    """The calibration taps of one batch, as the reference takes them: the
    token embeddings and the final normed hidden states, as f32 numpy
    arrays (both taps stand in for the block inputs, whose autocorrelation
    the data's locality drives at every depth, Fig. 3)."""
    batch = lm.as_batch(batch)
    x = lm.model_hidden(params, batch, cfg)
    emb = lm._embed(params, batch["tokens"])
    return [emb.float().cpu().numpy(), x.float().cpu().numpy()]


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16) if t.dtype == torch.float32 else t


@torch.no_grad()
def calibrate_and_quantize(params: dict, calib_batches: list,
                           cfg: ModelConfig, *, avg_budget: float = 4.125,
                           hi_bits: int = 8, lo_bits: int = 4,
                           transform: str = "dwt", levels: int = 3,
                           weight_bits: Optional[int] = 4, device=None
                           ) -> tuple[dict, lm.ServeConfig, PTQReport]:
    """Tap the embedding output and the final hidden states of each
    calibration batch, pick ``num_hi`` for the bit budget, and return
    serving params (bf16, large matmuls packed to int4, the encoder's
    too) with the matching ``ServeConfig``.

    A batch is a dict as the reference's: ``tokens``, plus ``frames``
    for an encoder-decoder stack or ``patches`` for a patch frontend (a
    batch without them raises the reference's ``KeyError``).  The
    embedding tap is the token embeddings alone, as the reference takes
    it, so a patch frontend's taps differ in length and the statistics
    raise the reference's broadcast ``ValueError``.

    Calibration runs layer-major: every batch through layer ``l``, then
    layer ``l`` is packed and released, so ``params["layers"]`` may be an
    iterator that draws each layer when it is reached
    (``lm.init_params(lazy=True)``) and no more than one unpacked layer is
    ever held.  The taps, and so every number, are those of the
    batch-major forward.  ``params`` must lie on ``device`` (``cuda``
    unless given)."""
    dev = resolve_device(device)
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in b.items()}
               for b in calib_batches]
    if not batches:
        raise ValueError("no calibration data")
    emb_taps = [lm._embed(params, b["tokens"]).float().cpu().numpy()
                for b in batches]
    xs = [lm.embed_inputs(params, b, cfg, encoder=False)[0]
          for b in batches]
    enc_outs = [None] * len(batches)
    sparams = {k: _bf16(v) for k, v in params.items()
               if k not in ("layers", "encoder")}
    if cfg.encoder_layers:
        # the encoder first, layer-major as the decoder below, each layer
        # packed once every batch has passed it
        enc = params["encoder"]
        es = [b["frames"].to(lm.COMPUTE_DTYPE) for b in batches]
        enc_packed = []
        for layer in enc["layers"]:
            es = [lm.encoder_layer(layer, e, cfg) for e in es]
            layer = {k: _bf16(v) for k, v in layer.items()}
            enc_packed.append(lm.quantize_weights_for_serving(
                layer, weight_bits) if weight_bits else layer)
        enc_outs = [L.rms_norm(e, enc["final_norm"].to(e.dtype),
                               cfg.norm_eps) for e in es]
        sparams["encoder"] = {"layers": enc_packed,
                              "final_norm": _bf16(enc["final_norm"])}
    packed = []
    # next() by hand: a zip over the layers would keep the previous layer
    # in its result tuple while the iterator draws the next one
    layers = iter(params["layers"])
    for spec in cfg.layer_specs():
        layer = next(layers)
        xs = [lm.prefill_layer(layer, spec, x, cfg, enc_out=e)[0]
              for x, e in zip(xs, enc_outs)]
        layer = {k: _bf16(v) for k, v in layer.items()}
        packed.append(lm.quantize_weights_for_serving(layer, weight_bits)
                      if weight_bits else layer)
        del layer           # before the iterator draws the next one
    stats: Optional[SiteStats] = None
    for emb, x in zip(emb_taps, xs):
        for tap in (emb, lm.final_hidden(params, x, cfg).float().cpu()
                    .numpy()):
            if stats is None:
                stats = SiteStats.empty(tap.shape[-2], tap.shape[-1])
            stats.update(tap)

    tf = toeplitz_fraction(stats.autocorr)
    order = np.sort(stats.energy_profile(transform, levels=levels))[::-1]
    num_hi = bitalloc.greedy_two_level(order, avg_budget, hi=hi_bits,
                                       lo=lo_bits)
    num_hi = max(1, min(num_hi, 64))
    head_frac = float(order[:num_hi].sum() / max(order.sum(), 1e-9))

    stamp = StampConfig(seq_transform=transform, levels=levels,
                        num_hi_tokens=num_hi, hi_bits=hi_bits,
                        lo_bits=lo_bits, skip_first_token=True)
    serve = lm.ServeConfig(
        stamp=stamp,
        kv=KVCacheConfig(quantized=True, num_hi=num_hi, hi_bits=hi_bits,
                         lo_bits=lo_bits),
        weight_bits=weight_bits)
    sparams["layers"] = packed
    seq = stats.autocorr.shape[0]
    report = PTQReport(
        num_hi=num_hi,
        avg_bits=float((num_hi * hi_bits + (seq - num_hi) * lo_bits) / seq),
        toeplitz_fraction=tf, energy_head_fraction=head_frac, sites=2)
    return sparams, serve, report

"""Table 2 — STaMP always improves LLM quantization (W4A4KV4, 16 tokens at
8 bits).

A small LM is trained briefly on the locally correlated corpus
(:func:`_trained`: the port's trainer, 400 steps), then evaluated
(:func:`evaluate`, which takes the parameters): the SQNR of the first
block's QKV projection on the model's true activations under each
feature-transform baseline (RTN, SmoothQuant, QuaRot, FlatQuant-lite) ×
STaMP off / on, and the held-out perplexity (the paper's WikiText-2 PPL
analog) in full precision and under A4 fake quantization everywhere with
16 tokens at 8 bits, without and with the sequence DWT.  QuaRot's signs
are drawn once from a generator seeded with 1, or given as ``signs``."""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core.feature_transforms import rademacher_signs
from repro_torch.core.stamp import StampConfig
from repro_torch.data.pipeline import DataConfig, markov_batch
from repro_torch.device import resolve_device
from repro_torch.launch.train import TrainConfig, train
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.paper.common import (QuantSetting, quantized_linear_output,
                                      sqnr_row, stamp_1d, timed)
from repro_torch.serving.kvcache import KVCacheConfig

METHODS = ["rtn", "smoothquant", "quarot", "flatquant"]

CFG = ModelConfig(name="bench-lm", family="dense", num_layers=4,
                  d_model=256, num_heads=8, num_kv_heads=4, d_ff=512,
                  vocab_size=256, tie_embeddings=True)
TRAIN = TrainConfig(steps=400, global_batch=8, seq=128, lr=3e-3, warmup=40)


@functools.lru_cache(maxsize=1)
def _trained(device: str) -> dict:
    return train(CFG, TRAIN, ckpt_dir=None, verbose=False,
                 device=device)["params"]


def _batch(step: int, device) -> dict:
    dcfg = DataConfig(vocab_size=CFG.vocab_size, seq_len=128,
                      global_batch=8)
    return {k: torch.from_numpy(v).to(device)
            for k, v in markov_batch(dcfg, step).items()}


def _block_inputs(params: dict, batch: dict) -> torch.Tensor:
    """True activations entering the first block's QKV projection, f32."""
    emb = lm._embed(params, batch["tokens"])
    p0 = params["layers"][0]
    return L.rms_norm(emb, p0["ln1"].to(emb.dtype)).float()


def _ppl(params: dict, batch: dict, stamp: Optional[StampConfig],
         kv: Optional[KVCacheConfig]) -> float:
    x = lm.model_hidden(params, batch, CFG, stamp=stamp, kv_cfg=kv)
    loss = lm.chunked_xent(x, lm._head_weight(params), batch["labels"])
    return float(torch.exp(loss))


@torch.no_grad()
def evaluate(params: dict, device=None, *,
             signs: Optional[torch.Tensor] = None) -> list:
    """Table 2's rows for ``params`` (the port's parameter dict of
    :data:`CFG`)."""
    dev = resolve_device(device)
    x = _block_inputs(params, _batch(-100, dev))
    x_calib = _block_inputs(params, _batch(-101, dev))
    w = params["layers"][0]["wq"].float()
    ref = x @ w
    if signs is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        signs = rademacher_signs(CFG.d_model, gen)
    rows = []
    for method in METHODS:
        for use_stamp in (False, True):
            setting = QuantSetting(
                method=method,
                stamp=stamp_1d(num_hi=16) if use_stamp else None,
                act_bits=4, weight_bits=4)
            us, y = timed(lambda: quantized_linear_output(
                x, w, setting, x_calib=x_calib, signs=signs),
                device=dev)
            rows.append(sqnr_row(
                f"table2/{method}{'+stamp' if use_stamp else ''}", us, ref,
                y))

    # end-to-end perplexity under A4 everywhere: 16 tokens at 8 bits in
    # both settings (the paper gives baselines the same mixed-precision
    # budget, §B.2); only the sequence transform differs
    batch = _batch(-102, dev)
    kv = KVCacheConfig(quantized=True, num_hi=16)

    def stamped(seq_transform: str) -> float:
        stamp = StampConfig(seq_transform=seq_transform, num_hi_tokens=16,
                            skip_first_token=True)
        return _ppl(params, batch, stamp, kv)

    base = stamped("none")
    with_stamp = stamped("dwt")
    fp = _ppl(params, batch, None, None)
    for name, v in (("ppl_fp", fp), ("ppl_a4_uniform", base),
                    ("ppl_a4_stamp", with_stamp)):
        rows.append({"name": f"table2/{name}", "us_per_call": 0.0,
                     "derived": f"ppl={v:.2f}"})
    return rows


def run(device=None) -> list:
    """Train :data:`CFG` with :data:`TRAIN` on ``device`` (once a device),
    then :func:`evaluate`."""
    dev = resolve_device(device)
    return evaluate(_trained(str(dev)), dev)

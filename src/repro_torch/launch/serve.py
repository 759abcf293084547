"""Serving driver of the port: PTQ a random-init model from a seed and serve
batched requests through the paged unified engine or the bucketed one.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
        --engine paged --step-mode unified --execution fused \\
        --fused-cache-attention --device cuda \\
        --requests 4 --prompt-len 96 --max-new 8

``--engine bucketed`` serves the same requests through the lockstep engine
over the contiguous cache (bucket 128, cache ``128 + --max-new`` tokens);
with ``--fused-cache-attention`` its decode attention is the packed-cache
kernel.

``--arch arctic-480b`` serves the MoE path (128 experts, top-2, dense
residual); at full width one H100 holds a few of its 35 layers, which a
caller cuts by passing a config to :func:`build`.  ``--arch deepseek-7b``,
``minicpm-2b``, ``mistral-nemo-12b`` and ``qwen2-72b`` serve the other
dense architectures; qwen2-72b whole needs about 90 GiB, so one H100
serves it cut the same way.

The flags are the reference CLI's (``repro.launch.serve``) for this path;
``--device`` (default ``cuda``) picks where it runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.ptq import calibrate_and_quantize
from repro_torch.data.pipeline import DataConfig, calibration_batches
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serving.engine import (BucketedEngine, EngineConfig,
                                        PagedEngineConfig, PagedServingEngine)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=96)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--no-stamp", action="store_true")
    ap.add_argument("--engine", choices=("paged", "bucketed"),
                    default="paged")
    ap.add_argument("--execution", choices=("reference", "fused"),
                    default="reference",
                    help="STaMP linear path: plain PyTorch or the fused "
                         "integer kernels")
    ap.add_argument("--fused-cache-attention", action="store_true",
                    help="attention through the paged (or, bucketed, the "
                         "packed contiguous) cache attention kernel")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=128)
    ap.add_argument("--step-mode", choices=("unified",), default="unified")
    ap.add_argument("--max-prefills", type=int, default=2)
    ap.add_argument("--prefix-cache", default=True,
                    action=argparse.BooleanOptionalAction)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _hand_over(layers: list):
    """Yield each layer and drop the list's reference to it, so the
    consumer holds the only one."""
    while layers:
        yield layers.pop(0)


def build(args: argparse.Namespace, cfg=None) -> tuple:
    """Seeded init → PTQ → engine, streamed one layer at a time: each layer
    is drawn in bf16 when calibration reaches it, packed to int4 and
    released, and the engine prepares and releases each packed layer in
    turn.  ``cfg`` overrides the ``--arch`` / ``--reduced`` config (for
    example a depth cut).  Returns ``(engine, cfg, report)``."""
    dev = resolve_device(args.device)
    if cfg is None:
        cfg = get_reduced(args.arch) if args.reduced \
            else get_config(args.arch)
    params = lm.init_params(cfg, seed=args.seed, device=dev,
                            dtype=torch.bfloat16, lazy=True)
    calib = calibration_batches(DataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=128, global_batch=4,
                                           seed=args.seed), num_batches=2)
    sparams, serve, report = calibrate_and_quantize(params, calib, cfg,
                                                    device=dev)
    del params
    if args.no_stamp:
        serve = lm.ServeConfig(stamp=None, kv=serve.kv,
                               weight_bits=serve.weight_bits)
    else:
        serve = dataclasses.replace(serve, stamp=dataclasses.replace(
            serve.stamp, execution=args.execution))
    serve = dataclasses.replace(
        serve, fused_cache_attention=args.fused_cache_attention)
    sparams["layers"] = _hand_over(sparams["layers"])
    max_seq = 128 + args.max_new
    if args.engine == "bucketed":
        engine = BucketedEngine(sparams, cfg, serve,
                                EngineConfig(max_batch=8, bucket=128,
                                             max_seq=max_seq), device=dev)
        return engine, cfg, report
    bs = args.block_size
    if serve.kv.num_hi % bs:
        bs = serve.kv.num_hi     # pages are single-precision
    engine = PagedServingEngine(
        sparams, cfg, serve,
        PagedEngineConfig(max_slots=8, prefill_chunk=args.prefill_chunk,
                          max_seq=max_seq, block_size=bs,
                          max_prefills=args.max_prefills,
                          prefix_caching=args.prefix_cache), device=dev)
    return engine, cfg, report


def serve_requests(engine, cfg, args) -> dict:
    """Submit ``args.requests`` seeded prompts, drain the engine and
    return the end-to-end numbers."""
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        engine.submit(rng.integers(0, cfg.vocab_size, args.prompt_len),
                      max_new_tokens=args.max_new)
    t0 = time.perf_counter()
    done = engine.run()
    dt = time.perf_counter() - t0
    total = sum(len(r.out_tokens) for r in done)
    ttfts = sorted(r.ttft_s for r in done)
    return {"requests": len(done), "tokens": total, "seconds": dt,
            "tokens_per_s": total / dt, "ttft_p50_s": ttfts[len(ttfts) // 2],
            "steps": engine.stats["steps"], "stats": dict(engine.stats),
            "outputs": {r.uid: r.out_tokens.tolist() for r in done}}


def main(argv=None) -> dict:
    args = parse_args(argv)
    engine, cfg, report = build(args)
    print(f"[ptq] num_hi={report.num_hi} avg_bits={report.avg_bits:.3f} "
          f"toeplitz={report.toeplitz_fraction:.3f} "
          f"head_energy={report.energy_head_fraction:.3f}")
    res = serve_requests(engine, cfg, args)
    where = torch.cuda.get_device_name(engine.device) \
        if engine.device.type == "cuda" else "cpu"
    mode = "paged:unified" if args.engine == "paged" else "bucketed"
    print(f"[serve:{mode}] {res['requests']} requests, "
          f"{res['tokens']} tokens in {res['seconds']:.2f}s "
          f"({res['tokens_per_s']:.1f} tok/s on {where}), "
          f"ttft p50={res['ttft_p50_s']:.3f}s, steps={res['steps']} "
          f"prefill_chunks={res['stats']['prefill_chunks']} "
          f"preemptions={res['stats']['preemptions']}")
    for uid, toks in list(res["outputs"].items())[:3]:
        print(f"  req {uid}: {toks[:10]}")
    return res


if __name__ == "__main__":
    main()

"""Serving driver of the port: PTQ a random-init model from a seed and serve
batched requests through the paged unified engine or the bucketed one.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
        --engine paged --step-mode unified --execution fused \\
        --fused-cache-attention --device cuda \\
        --requests 4 --prompt-len 96 --max-new 8

``--engine bucketed`` serves the same requests through the lockstep engine
over the contiguous cache (prompts right-padded to ``--bucket`` tokens,
default 128); with ``--fused-cache-attention`` its decode attention is the
packed-cache kernel.  Either engine caps a request at ``max(128, --bucket,
--prompt-len) + --max-new`` tokens (the reference's ``128 + --max-new``
for prompts of up to 128 tokens); prefill spans of any length
(``--prefill-chunk``, ``--bucket``) run the fused kernels on the card.

``--step-mode two_call`` runs each paged step as one prefill chunk
(``lm.paged_prefill_chunk``) and then the decode slots
(``lm.paged_decode_step``), as the reference's two-call engine does.  The
robustness flags (``--deadline-s``, ``--ttft-deadline-s``,
``--max-waiting``, ``--shed-policy``, ``--watermark``,
``--numerics-guard``, ``--chaos SEED``) configure the paged engine; the
observability flags (``--metrics-json``, ``--metrics-prom``,
``--trace-out``, ``--quant-telemetry``) write the engine's registry and
event ring when the run ends.

``--arch arctic-480b`` serves the MoE path (128 experts, top-2, dense
residual); at full width one H100 holds a few of its 35 layers, which a
caller cuts by passing a config to :func:`build`; ``kimi-k2-1t-a32b``
(384 experts top-8 after a dense first layer) the same way.
``--arch jamba-1.5-large-398b`` serves the hybrid stack (paged K/V for its
attention layers, the slot-dense SSM state pool for its Mamba layers;
prefix caching is off with Mamba layers), ``mamba2-1.3b`` the pure-SSM
stack pageless (slots are its only capacity).  ``--arch deepseek-7b``,
``minicpm-2b``, ``mistral-nemo-12b`` and ``qwen2-72b`` serve the other
dense architectures; qwen2-72b whole needs about 90 GiB, so one H100
serves it cut the same way.  ``--arch pixart-sigma`` serves the DiT
backbone (head_dim 72, a stub vocabulary of 8) through either engine.
``llava-next-mistral-7b`` and ``seamless-m4t-large-v2`` take patches or
frames beside their tokens, which neither the calibration batches nor
the engines carry: PTQ raises the reference's ``KeyError``, and an
enc-dec arch with ``--engine paged`` is an argument error naming
``--engine bucketed``.  Their entry points are the model API,
``lm.prefill`` on a batch dict and then ``lm.decode_step``.

The flags are the reference CLI's (``repro.launch.serve``) for this path;
``--device`` (default ``cuda``) picks where it runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.ptq import calibrate_and_quantize
from repro_torch.data.pipeline import DataConfig, calibration_batches
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.obs.trace import export_chrome_trace
from repro_torch.serving.faults import FaultPlan
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
                    default="paged",
                    help="paged = continuous batching over the block-paged "
                         "cache and the slot-dense SSM state pool (dense, "
                         "MoE, hybrid and pure-SSM stacks); bucketed = "
                         "lockstep slot batching over the contiguous cache")
    ap.add_argument("--execution", choices=("reference", "fused"),
                    default="reference",
                    help="STaMP linear path: plain PyTorch or the fused "
                         "integer kernels")
    ap.add_argument("--fused-cache-attention", action="store_true",
                    help="attention through the paged (or, bucketed, the "
                         "packed contiguous) cache attention kernel")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=128)
    ap.add_argument("--bucket", type=int, default=128,
                    help="prompt bucket length of the bucketed engine")
    ap.add_argument("--step-mode", choices=("unified", "two_call"),
                    default="unified",
                    help="unified = one forward a step (prefill chunks + "
                         "decode slots); two_call = a prefill chunk, then "
                         "the decode slots")
    ap.add_argument("--max-prefills", type=int, default=2)
    ap.add_argument("--prefix-cache", default=True,
                    action=argparse.BooleanOptionalAction)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    # -- robustness / admission control (paged engine) ----------------------
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request total latency budget in seconds; "
                         "requests past it fail at plan time")
    ap.add_argument("--ttft-deadline-s", type=float, default=None,
                    help="per-request first-token budget in seconds")
    ap.add_argument("--max-waiting", type=int, default=None,
                    help="bounded waiting queue: beyond this depth the "
                         "shed policy decides who is turned away")
    ap.add_argument("--shed-policy", choices=("reject_newest",
                                              "shed_oldest"),
                    default="reject_newest")
    ap.add_argument("--watermark", type=float, default=1.0,
                    help="page-pool occupancy fraction that triggers early "
                         "preemption (1.0 = only on true exhaustion)")
    ap.add_argument("--numerics-guard", action="store_true",
                    help="check step outputs for NaN/Inf and quarantine "
                         "the request (fused STaMP engines also demote to "
                         "reference execution)")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="inject seeded faults (page exhaustion, swap "
                         "corruption, NaN) through a FaultPlan")
    # -- observability ------------------------------------------------------
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write the metrics registry snapshot as JSON")
    ap.add_argument("--metrics-prom", default=None, metavar="PATH",
                    help="write the registry in Prometheus text format")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the event ring as Chrome trace-event JSON")
    ap.add_argument("--quant-telemetry", action="store_true",
                    help="collect per-STaMP-site quant-health stats with "
                         "each step")
    args = ap.parse_args(argv)
    if args.engine == "paged":
        cfg = get_reduced(args.arch) if args.reduced \
            else get_config(args.arch)
        if cfg.encoder_layers:
            # fail at the CLI boundary with the fix in hand: an enc-dec
            # stack's cross-attention K/V is held dense per request
            ap.error(f"--engine paged does not support encoder-decoder "
                     f"stacks ({cfg.name}: encoder_layers="
                     f"{cfg.encoder_layers}); run with --engine bucketed")
    return args


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
        serve, fused_cache_attention=args.fused_cache_attention,
        numerics_guard=args.numerics_guard,
        quant_telemetry=args.quant_telemetry)
    sparams["layers"] = _hand_over(sparams["layers"])
    max_seq = max(128, args.bucket, args.prompt_len) + args.max_new
    if args.engine == "bucketed":
        engine = BucketedEngine(sparams, cfg, serve,
                                EngineConfig(max_batch=8, bucket=args.bucket,
                                             max_seq=max_seq), device=dev)
        return engine, cfg, report
    bs = args.block_size
    if serve.kv.num_hi % bs:
        bs = serve.kv.num_hi     # pages are single-precision
    fault = None
    if args.chaos is not None:
        fault = FaultPlan(seed=args.chaos, exhaust_rate=0.2,
                          corrupt_rate=0.3, nan_rate=0.005)
    engine = PagedServingEngine(
        sparams, cfg, serve,
        PagedEngineConfig(max_slots=8, prefill_chunk=args.prefill_chunk,
                          max_seq=max_seq, block_size=bs,
                          step_mode=args.step_mode,
                          max_prefills=args.max_prefills,
                          max_waiting=args.max_waiting,
                          shed_policy=args.shed_policy,
                          preempt_watermark=args.watermark,
                          prefix_caching=args.prefix_cache), device=dev,
        fault=fault)
    return engine, cfg, report


def serve_requests(engine, cfg, args) -> dict:
    """Submit ``args.requests`` seeded prompts, drain the engine and
    return the end-to-end numbers."""
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        engine.submit(rng.integers(0, cfg.vocab_size, args.prompt_len),
                      max_new_tokens=args.max_new,
                      deadline_s=args.deadline_s,
                      ttft_deadline_s=args.ttft_deadline_s)
    t0 = time.perf_counter()
    done = engine.run()
    dt = time.perf_counter() - t0
    total = sum(len(r.out_tokens) for r in done)
    ttfts = sorted(r.ttft_s for r in done)
    return {"requests": len(done), "tokens": total, "seconds": dt,
            "tokens_per_s": total / dt, "ttft_p50_s": ttfts[len(ttfts) // 2],
            "steps": engine.stats["steps"], "stats": dict(engine.stats),
            "outputs": {r.uid: r.out_tokens.tolist() for r in done},
            "status": {r.uid: r.status for r in done}}


def eligibility_lines(engine) -> list:
    """The ``[serve:eligibility]`` lines: each STaMP site's fused or
    reference status, kernel and layers, then the fallback count."""
    lines = []
    for site, cell in engine.eligibility.items():
        why = f" ({','.join(cell['reasons'])})" if cell["reasons"] else ""
        lines.append(f"[serve:eligibility] {site:<12} {cell['status']:<9} "
                     f"kernel={cell['kernel'] or '-'} "
                     f"layers={cell['layers']}{why}")
    n_ref = engine.stats["reference_fallback_sites"]
    lines.append(f"[serve:eligibility] reference_fallback_sites={n_ref}")
    if n_ref == 0 and "moe" in engine.eligibility:
        lines.append("[serve:eligibility] full fused coverage: every STaMP "
                     "site incl. grouped MoE runs the integer kernels")
    return lines


def lifecycle_line(stats: dict) -> str:
    """The ``[serve:lifecycle]`` line: how the requests ended."""
    return (f"[serve:lifecycle] finished={stats['finished']} "
            f"failed={stats['failed']} cancelled={stats['cancelled']} "
            f"rejected={stats['rejected']} shed={stats['shed']} "
            f"deadline_misses={stats['deadline_misses']} "
            f"nan_quarantines={stats['nan_quarantines']} "
            f"demotions={stats['demotions']} "
            f"watchdog_trips={stats['watchdog_trips']}")


def write_outputs(engine, args) -> list:
    """Write the files the observability flags ask for; returns the
    lines to print."""
    lines = []
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            f.write(engine.metrics.to_json())
        lines.append(f"[obs] metrics snapshot -> {args.metrics_json}")
    if args.metrics_prom:
        with open(args.metrics_prom, "w") as f:
            f.write(engine.metrics.to_prometheus())
        lines.append(f"[obs] prometheus text -> {args.metrics_prom}")
    if args.trace_out:
        trace = export_chrome_trace(engine.events, engine=args.engine)
        with open(args.trace_out, "w") as f:
            json.dump(trace, f)
        lines.append(f"[obs] {len(trace['traceEvents'])} trace events -> "
                     f"{args.trace_out}")
    if args.quant_telemetry:
        snap = engine.metrics.snapshot()
        rates = {k: round(v, 4) for k, v in snap["gauges"].items()
                 if k.startswith("quant_clip_rate")}
        if rates:
            lines.append(f"[obs] quant clip rates: {rates}")
    return lines


def main(argv=None) -> dict:
    args = parse_args(argv)
    engine, cfg, report = build(args)
    print(f"[ptq] num_hi={report.num_hi} avg_bits={report.avg_bits:.3f} "
          f"toeplitz={report.toeplitz_fraction:.3f} "
          f"head_energy={report.energy_head_fraction:.3f}")
    for line in eligibility_lines(engine):
        print(line)
    res = serve_requests(engine, cfg, args)
    where = torch.cuda.get_device_name(engine.device) \
        if engine.device.type == "cuda" else "cpu"
    mode = f"paged:{args.step_mode}" if args.engine == "paged" \
        else "bucketed"
    print(f"[serve:{mode}] {res['requests']} requests, "
          f"{res['tokens']} tokens in {res['seconds']:.2f}s "
          f"({res['tokens_per_s']:.1f} tok/s on {where}), "
          f"ttft p50={res['ttft_p50_s']:.3f}s, steps={res['steps']} "
          f"prefill_chunks={res['stats']['prefill_chunks']} "
          f"preemptions={res['stats']['preemptions']}")
    if args.engine == "paged":
        print(lifecycle_line(res["stats"]))
    for uid, toks in list(res["outputs"].items())[:3]:
        print(f"  req {uid}: {toks[:10]}")
    for line in write_outputs(engine, args):
        print(line)
    return res


if __name__ == "__main__":
    main()

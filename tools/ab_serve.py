#!/usr/bin/env python3
"""Same-card A/B of two trees' serve path: llama3-8b at full width through
the paged unified engine (fused STaMP, the paged attention kernel), 4
requests x 96 prompt tokens x 8 new tokens, as ``chip_smoke.py`` serves it.

    python3 tools/ab_serve.py --old DIR [--new DIR] [--order old,new,new,old]
                              [--rounds 3]

``DIR`` is the root of a checkout (or of a ``git archive`` of one); ``--new``
defaults to this checkout.  Each run of the order is its own process on the
one card: it builds that tree's kernels into its own build directory,
serves once to warm up, then ``--rounds`` times on a freshly built engine
each (the same seeded prompts, so every round does the same work), timing
``serve_requests`` (host clock, ending in the last step's transfer).
Prints one ``[ab]`` line a run and last a JSON object with every run;
needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARGV = ["--arch", "llama3-8b", "--engine", "paged", "--step-mode", "unified",
        "--execution", "fused", "--fused-cache-attention", "--device", "cuda",
        "--requests", "4", "--prompt-len", "96", "--max-new", "8"]


def worker(src: Path, build: Path, rounds: int) -> dict:
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build)
    sys.path.insert(0, str(src / "src"))
    import torch
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.launch import serve
    if not torch.cuda.is_available():
        sys.exit("the A/B needs a CUDA card")
    kcuda.build()
    args = serve.parse_args(ARGV)
    timed = ("tokens_per_s", "seconds", "ttft_p50_s")
    out = {k: [] for k in timed}
    for i in range(rounds + 1):
        engine, cfg, _ = serve.build(args)
        torch.cuda.synchronize()
        res = serve.serve_requests(engine, cfg, args)
        if i:                                   # round 0 warms up
            for k in timed:
                out[k].append(res[k])
        out["steps"] = res["steps"]
        out["outputs"] = res["outputs"]
        del engine
        torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path)
    ap.add_argument("--new", type=Path, default=ROOT)
    ap.add_argument("--order", default="old,new,new,old")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--build", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.build, args.rounds)))
        return
    if args.old is None:
        ap.error("--old is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    trees = {"old": args.old, "new": args.new}
    runs = []
    for i, label in enumerate(args.order.split(",")):
        src = Path(trees[label]).resolve()
        out = subprocess.run([sys.executable, __file__, "--worker", str(src),
                              "--build", str(ROOT / "build" / f"ab_{label}"),
                              "--rounds", str(args.rounds)],
                             capture_output=True, text=True)
        if out.returncode:
            sys.stderr.write(out.stdout + out.stderr)
            sys.exit(f"run {i} ({label}) failed")
        res = json.loads(out.stdout.strip().splitlines()[-1])
        print(f"[ab] run {i} {label}: tokens/s {res['tokens_per_s']} "
              f"seconds {res['seconds']} ttft_p50 {res['ttft_p50_s']} "
              f"steps {res['steps']}")
        runs.append(dict(label=label, **res))
    outs = {json.dumps(r["outputs"], sort_keys=True) for r in runs}
    print(f"[ab] ids identical across runs: {len(outs) == 1}")
    print(json.dumps({"card": smi, "runs": runs}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Same-card A/B of two builds of the port's K1 (STaMP transform +
quantize), K4 (paged attention), K2 (STaMP int GEMM), K3 (decode matmul),
K5 (grouped MoE expert FFN), K6 (decode
attention over the contiguous packed cache), K7 (standalone int8 GEMM), K8
(quantize + pack) and K10 (Walsh-Hadamard transform) kernels, at every
site of theirs that ``chip_smoke.py`` times.

    python3 tools/ab_kernels.py --old DIR [--new DIR] [--tree NAME=DIR ...]
                                [--order old,new,new,old]
                                [--kernels k1,k2,k3,k4,k5,k6,k7,k8,k10]

``DIR`` is the root of a checkout (or of a ``git archive`` of one) holding
``src/repro_torch``; ``--new`` defaults to this checkout, and ``--tree``
names further trees for the order.  Each run of the order is its own
process on the one card: it builds that tree's sources of the chosen
kernels into its own build directory and runs this checkout's
``chip_smoke.check_k1``, ``check_stamp``, ``check_decode``,
``check_attention``, ``check_grouped_all``, ``check_cache_attention``
(Kimi-K2's head_dim 112 rows only where that tree's K6 takes it),
``check_int8_gemm``, ``check_pack`` and ``check_wht`` with that tree's
modules: the same sites, checks against the plain versions and timings as
the smoke
(eager and replayed from CUDA graphs, beside the library yardsticks);
``--kernels`` keeps a subset.  Prints one ``[ab]`` line a run and site,
and last a JSON object with every run; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("ms", "graph_ms", "copy_graph_ms", "library_ms", "library_graph_ms",
        "library_row_major_ms", "library_col_major_ms",
        "library_row_major_graph_ms", "library_col_major_graph_ms")


def worker(src: Path, build: Path, kernels: str) -> dict:
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build)
    sys.path.insert(0, str(src / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as cs
    from repro_torch.core.stamp import prepare_linear, token_quantize
    from repro_torch.kernels import cache_attention as ca
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.kernels import decode_matmul as dm
    from repro_torch.kernels import int8_gemm as im
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import quant_pack as qp
    from repro_torch.kernels import ref
    from repro_torch.kernels import stamp_matmul as sm
    from repro_torch.kernels import wht as wt
    from repro_torch.models import layers as L
    from repro_torch.serving import kvcache as KV
    from repro_torch.serving import paged_kvcache as PKV
    if not torch.cuda.is_available():
        cs.fail("the A/B needs a CUDA card")
    assert Path(pa.__file__).resolve().is_relative_to(src.resolve())
    want = set(kernels.split(","))
    kcuda.build(sorted({n for k, n in (("k1", "stamp_matmul"),
                                       ("k2", "stamp_matmul"),
                                       ("k3", "decode_matmul"),
                                       ("k4", "paged_attention"),
                                       ("k5", "grouped_matmul"),
                                       ("k6", "cache_attention"),
                                       ("k7", "int8_matmul"),
                                       ("k8", "quant_pack"),
                                       ("k10", "wht")) if k in want}))
    stamp = [dict(sites=cs.LLAMA_SITES), dict(sites=cs.ARCTIC_SITES,
                                              seed=5)]
    stamp += [dict(sites=cs.LLAMA_SITES, seed=7 + s, spans=s,
                   tag=f"bucketed{s}_") for s in cs.BUCKETED_SPANS]
    rows = {}
    with torch.inference_mode():
        for heads, prefix in ((cs.HEADS, ""), (cs.A_HEADS, "arctic_")) \
                if "k4" in want else ():
            for r in cs.check_attention(torch, pa, PKV, KV, heads=heads,
                                        prefix=prefix):
                rows[f"K4 {r['site']}"] = r
        for kw in stamp if "k1" in want else ():
            for r in cs.check_k1(torch, sm, **kw):
                rows[f"K1 {r['site']}"] = r
        for kw in stamp if "k2" in want else ():
            _, k2 = cs.check_stamp(torch, sm, ops, prepare_linear, **kw)
            for r in k2:
                rows[f"K2 {r['site']}"] = r
            torch.cuda.empty_cache()
        decode = [dict(sites=cs.LLAMA_DECODE_SITES),
                  dict(sites=cs.ARCTIC_DECODE_SITES, seed=6),
                  dict(sites=cs.BUCKETED_DECODE_SITES, seed=8,
                       rows=cs.BUCKETED_ROWS)]
        for kw in decode if "k3" in want else ():
            for r in cs.check_decode(torch, dm, prepare_linear, **kw):
                rows[f"K3 {r['site']}"] = r
        if "k5" in want:
            for r in cs.check_grouped_all(torch, sm, L, token_quantize):
                rows[f"K5 {r['site']}"] = r
            torch.cuda.empty_cache()
        if "k6" in want:
            shapes = [dict()]
            if cs.KIMI_HD in ca._HEAD_DIMS:
                shapes.append(dict(heads=cs.KIMI_HEADS, hd=cs.KIMI_HD,
                                   prefix="kimi_"))
            for kw in shapes:
                for r in cs.check_cache_attention(torch, ca, ref, KV, **kw):
                    rows[f"K6 {r['site']}"] = r
            torch.cuda.empty_cache()
        if "k7" in want:
            gen = torch.Generator(device="cuda").manual_seed(9)
            for r in cs.check_int8_gemm(torch, im, gen):
                rows[f"K7 {r['site']}"] = r
        if "k8" in want:
            gen = torch.Generator(device="cuda").manual_seed(9)
            for r in cs.check_pack(torch, qp, gen):
                rows[f"K8 {r['site']}"] = r
        if "k10" in want:
            gen = torch.Generator(device="cuda").manual_seed(9)
            for r in cs.check_wht(torch, wt, gen):
                rows[f"K10 {r['site']}"] = r
    return {site: {k: r[k] for k in KEYS if k in r} for site, r in
            rows.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path)
    ap.add_argument("--new", type=Path, default=ROOT)
    ap.add_argument("--tree", action="append", default=[],
                    metavar="NAME=DIR")
    ap.add_argument("--order", default="old,new,new,old")
    ap.add_argument("--kernels", default="k2,k3,k4,k7")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--build", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.build, args.kernels)))
        return
    if args.old is None:
        ap.error("--old is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    trees = {"old": args.old, "new": args.new}
    trees.update(dict(t.split("=", 1) for t in args.tree))
    runs = []
    for i, label in enumerate(args.order.split(",")):
        src = Path(trees[label])
        build = ROOT / "build" / f"ab_{label}"
        out = subprocess.run([sys.executable, __file__, "--worker",
                              str(src.resolve()), "--build", str(build),
                              "--kernels", args.kernels],
                             capture_output=True, text=True)
        if out.returncode:
            sys.stderr.write(out.stdout + out.stderr)
            sys.exit(f"run {i} ({label}) failed")
        rows = json.loads(out.stdout.strip().splitlines()[-1])
        for site, r in rows.items():
            print(f"[ab] run {i} {label} {site}: {json.dumps(r)}")
        runs.append(dict(label=label, rows=rows))
    print(json.dumps({"card": smi, "runs": runs}))


if __name__ == "__main__":
    main()

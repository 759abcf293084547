"""Run the port's full dry-run grid (arch × shape × mesh) in subprocesses,
the port of ``repro.launch.sweep``.

One subprocess per cell keeps each trace's memory its own and makes the
sweep resumable: cells with an ``ok``, ``skipped`` or ``refused`` record
are kept (delete the file or pass ``--force`` to re-run).  ``--jobs``
cells run at once (one PyTorch thread each).  Usage::

    PYTHONPATH=src python -m repro_torch.launch.sweep [--only-singlepod] \\
        [--force] [--jobs 4]
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parents[3]
OUT_DIR = ROOT / "experiments" / "dryrun_torch"

ARCHS = [
    "minicpm-2b", "deepseek-7b", "mistral-nemo-12b", "qwen2-72b",
    "llava-next-mistral-7b", "jamba-1.5-large-398b", "seamless-m4t-large-v2",
    "kimi-k2-1t-a32b", "arctic-480b", "mamba2-1.3b",
]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
DONE = ("ok", "skipped", "refused")


def _cell_args(arch: str, shape: str, multi_pod: bool, extra=()) -> list:
    return ["--arch", arch, "--shape", shape, *extra] + \
        (["--multi-pod"] if multi_pod else [])


def cell_path(out_dir: pathlib.Path, arch: str, shape: str,
              multi_pod: bool, extra=()) -> pathlib.Path:
    """The record the dry run writes for the cell (its stem from the
    dry run's own flags)."""
    from repro_torch.launch import dryrun
    args = dryrun.parser().parse_args(_cell_args(arch, shape, multi_pod,
                                                 extra))
    return out_dir / f"{dryrun.record_stem(args)}.json"


def run_cell(arch: str, shape: str, multi_pod: bool, extra=(),
             out_dir=None, timeout: int = 3600) -> str:
    out_dir = out_dir or OUT_DIR
    out = cell_path(out_dir, arch, shape, multi_pod, extra)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           *_cell_args(arch, shape, multi_pod, extra), "--save-ops",
           "--out-dir", str(out_dir)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          cwd=str(ROOT), timeout=timeout, env=env)
    dt = time.time() - t0
    if proc.returncode != 0:
        err = proc.stderr.strip().splitlines()[-1] if proc.stderr else "?"
        out.write_text(json.dumps(
            {"status": "error", "error": err, "t_s": dt}, indent=2))
        return f"ERROR ({dt:.0f}s): {err[:120]}"
    rec = json.loads(out.read_text())
    if rec.get("status") != "ok":
        return f"{rec['status']} ({dt:.0f}s): {rec['reason'][:60]}"
    r = rec["roofline"]
    return (f"ok ({dt:.0f}s) bottleneck={r['bottleneck']} "
            f"frac={r['roofline_fraction']:.4f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--only-singlepod", action="store_true")
    ap.add_argument("--only-multipod", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out-dir", default="")
    ap.add_argument("--archs", default="",
                    help="comma-separated archs (default: the grid's)")
    ap.add_argument("--shapes", default="",
                    help="comma-separated shapes (default: the grid's)")
    ap.add_argument("--extra", default="",
                    help="comma-separated extra dryrun flags")
    ap.add_argument("--jobs", type=int, default=1)
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out_dir) if args.out_dir else OUT_DIR
    extra = tuple(x for x in args.extra.split(",") if x)
    out_dir.mkdir(parents=True, exist_ok=True)
    meshes = [False, True]
    if args.only_singlepod:
        meshes = [False]
    if args.only_multipod:
        meshes = [True]
    archs = args.archs.split(",") if args.archs else ARCHS
    shapes = args.shapes.split(",") if args.shapes else SHAPES

    t0 = time.time()
    todo = []
    for multi_pod in meshes:
        mesh_tag = "multipod" if multi_pod else "singlepod"
        for arch in archs:
            for shape in shapes:
                out = cell_path(out_dir, arch, shape, multi_pod, extra)
                tag = f"{arch:24s} {shape:12s} {mesh_tag:10s}"
                if out.exists() and not args.force:
                    rec = json.loads(out.read_text())
                    if rec.get("status") in DONE:
                        print(f"{tag} cached:{rec['status']}", flush=True)
                        continue
                todo.append((tag, arch, shape, multi_pod))

    def one(item):
        tag, arch, shape, multi_pod = item
        msg = run_cell(arch, shape, multi_pod, extra=extra, out_dir=out_dir)
        print(f"{tag} {msg}", flush=True)

    with ThreadPoolExecutor(max(args.jobs, 1)) as pool:
        list(pool.map(one, todo))
    print(f"sweep done in {time.time() - t0:.0f}s")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Does a resumed training run compute what a clean run does, bit for
bit, on the card?

    python3 tools/train_determinism.py [--device cuda] [--repeats 2]
        [--archs minicpm-2b,arctic-480b,mamba2-1.3b]

For each arch, runs the reference test's crash-and-restart trio
(``tests/test_distributed.py``: the reduced config, 12 steps of 2 x 64, a
checkpoint every 4 steps, a hard crash at step 6) through ``python -m
repro_torch.launch.train``, beside ``--repeats`` clean runs, all started
together.  Prints a line an arch: how many leaves of the step-12
checkpoint (CRC32 of each) differ between the resumed run and the first
clean run and between the clean runs, and the final-loss lines.  The
default archs are the reference test's dense one, an MoE stack and an SSM
stack.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--reduced", "--steps", "12", "--global-batch", "2", "--seq", "64",
        "--ckpt-every", "4"]


def run(device: str, arch: str, ckpt: Path, *extra) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--device",
         device, "--arch", arch, *ARGS, "--ckpt-dir", str(ckpt), *extra],
        env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish(proc: subprocess.Popen, rc: int = 0) -> str:
    out, err = proc.communicate(timeout=600)
    if proc.returncode != rc:
        sys.exit(f"exit {proc.returncode}, not {rc}:\n{err[-2000:]}")
    return out


def crcs(ckpt: Path) -> dict:
    index = json.loads((ckpt / "step_00000012" / "index.json").read_text())
    return {k: v["crc32"] for k, v in index["leaves"].items()}


def trio(device: str, arch: str, repeats: int, tmp: Path) -> dict:
    crash = run(device, arch, tmp / "crash", "--fail-at-step", "6")
    cleans = [run(device, arch, tmp / f"clean{i}") for i in range(repeats)]
    finish(crash, 17)
    finals = [finish(p).strip().splitlines()[-1] for p in cleans]
    out = finish(run(device, arch, tmp / "crash"))
    assert "[restore] resumed from step 4" in out
    ref = crcs(tmp / "clean0")
    return {"device": device, "arch": arch, "leaves": len(ref),
            "resumed_vs_clean_differ": sum(
                crcs(tmp / "crash")[n] != v for n, v in ref.items()),
            "clean_vs_clean_differ": [
                sum(crcs(tmp / f"clean{i}")[n] != v for n, v in ref.items())
                for i in range(1, repeats)],
            "final_resumed": out.strip().splitlines()[-1],
            "final_clean": finals}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--archs", default="minicpm-2b,arctic-480b,mamba2-1.3b")
    args = ap.parse_args()
    for arch in args.archs.split(","):
        tmp = Path(tempfile.mkdtemp(prefix="determinism_"))
        try:
            row = trio(args.device, arch, args.repeats, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()

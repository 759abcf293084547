"""Re-derive the dry-run records' ``op_stats`` and ``roofline`` from their
saved op logs (no retracing), the port of ``repro.launch.reanalyze``.

Used whenever the op statistics or the roofline constants change: the op
logs are the ground truth, the JSON records are views.  Keeps the
``memory`` fields of the original record (they come from the trace).
Usage:  PYTHONPATH=src python -m repro_torch.launch.reanalyze [--dir DIR]
"""

from __future__ import annotations

import argparse
import gzip
import json
import pathlib

from repro_torch.analysis import opstats as OS
from repro_torch.analysis import roofline as rl
from repro_torch.configs import get_config, get_reduced
from repro_torch.launch.sweep import OUT_DIR
from repro_torch.models.config import SHAPES


def reanalyze(json_path: pathlib.Path) -> str:
    rec = json.loads(json_path.read_text())
    if rec.get("status") != "ok":
        return "skip"
    ops_path = json_path.parent / (json_path.stem + ".ops.json.gz")
    if not ops_path.exists():
        return "no-op-log"
    if "arch" not in rec:
        return "no-cell"       # traced through the API, not the CLI
    cfg = (get_reduced if rec["reduced"] else get_config)(rec["arch"])
    shape = SHAPES[rec["shape"]]
    with gzip.open(ops_path, "rt") as f:
        stats = OS.op_stats(json.load(f))
    roof = rl.compute_roofline(stats, cfg, shape, rec["chips"])
    rec["op_stats"] = stats
    rec["roofline"] = rl.summarize(roof)
    rec["op_count"] = stats["device_ops"]
    json_path.write_text(json.dumps(rec, indent=2, default=str))
    return f"ok {roof.bottleneck} frac={roof.roofline_fraction:.4f}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=str(OUT_DIR))
    args = ap.parse_args(argv)
    for p in sorted(pathlib.Path(args.dir).glob("*.json")):
        print(f"{p.stem:60s} {reanalyze(p)}", flush=True)


if __name__ == "__main__":
    main()

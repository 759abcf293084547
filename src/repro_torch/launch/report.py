"""Render the port's dry-run records as the roofline and dry-run tables,
the port of ``repro.launch.report``.  Usage:

    PYTHONPATH=src python -m repro_torch.launch.report \\
        [--dir experiments/dryrun_torch] [--section roofline|dryrun] \\
        [--mesh singlepod|multipod] [--suffix _reduced]
"""

from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.launch.sweep import ARCHS, OUT_DIR, SHAPES


def fmt(x, n=3):
    return f"{x:.{n}f}"


def roofline_table(d: pathlib.Path, mesh: str, suffix: str = "") -> str:
    lines = [
        "| arch | shape | compute s | memory s | collective s | bottleneck |"
        " roofline frac | useful FLOPs | cell s |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCHS:
        for shape in SHAPES:
            p = d / f"{arch}_{shape}_{mesh}{suffix}.json"
            if not p.exists():
                lines.append(f"| {arch} | {shape} | — | — | — | missing | "
                             f"| | |")
                continue
            rec = json.loads(p.read_text())
            cell_s = fmt(rec["t_s"], 1) if "t_s" in rec else ""
            if rec.get("status") in ("skipped", "refused"):
                lines.append(f"| {arch} | {shape} | | | | "
                             f"*{rec['reason']}* | | | {cell_s} |")
                continue
            if rec.get("status") != "ok":
                lines.append(f"| {arch} | {shape} | | | | ERROR | | | "
                             f"{cell_s} |")
                continue
            r = rec["roofline"]
            lines.append(
                f"| {arch} | {shape} | {fmt(r['compute_s'])} | "
                f"{fmt(r['memory_s'])} | {fmt(r['collective_s'])} | "
                f"{r['bottleneck']} | {fmt(r['roofline_fraction'], 4)} | "
                f"{fmt(r['useful_flops_ratio'], 4)} | {cell_s} |")
    return "\n".join(lines)


def dryrun_table(d: pathlib.Path, suffix: str = "") -> str:
    lines = [
        "| arch | shape | mesh | chips | arg GB/dev | temp GB/dev | "
        "dot GF/dev | coll GB/dev | ops | trace s |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCHS:
        for shape in SHAPES:
            for mesh in ("singlepod", "multipod"):
                p = d / f"{arch}_{shape}_{mesh}{suffix}.json"
                if not p.exists():
                    continue
                rec = json.loads(p.read_text())
                if rec.get("status") != "ok":
                    if mesh == "singlepod" and rec.get("status") == "skipped":
                        lines.append(f"| {arch} | {shape} | both | | | | "
                                     f"*skipped (long_500k rule)* | | | |")
                    continue
                m = rec["memory"]
                h = rec["op_stats"]
                lines.append(
                    f"| {arch} | {shape} | {mesh} | {rec['chips']} | "
                    f"{m['argument_bytes_per_device']/1e9:.2f} | "
                    f"{m['temp_bytes_per_device']/1e9:.2f} | "
                    f"{h['dot_flops_per_device']/1e9:.0f} | "
                    f"{h['collective_bytes_per_device']/1e9:.1f} | "
                    f"{rec['op_count']} | {rec['t_trace_s']} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=str(OUT_DIR))
    ap.add_argument("--section", default="roofline",
                    choices=["roofline", "dryrun"])
    ap.add_argument("--mesh", default="singlepod")
    ap.add_argument("--suffix", default="",
                    help="the records' variant suffix (e.g. _reduced)")
    args = ap.parse_args(argv)
    d = pathlib.Path(args.dir)
    if args.section == "roofline":
        print(roofline_table(d, args.mesh, args.suffix))
    else:
        print(dryrun_table(d, args.suffix))


if __name__ == "__main__":
    main()

"""Run every ported paper table and figure and print the reference's
``name,us_per_call,derived`` CSV.

    PYTHONPATH=src python -m repro_torch.paper.run [--device cpu]

Runs on ``cuda`` unless ``--device`` names another device; without a card
a CUDA run raises.  Table 2 trains its LM first (400 steps of the port's
trainer); the kernel throughput suite is not among the modules."""

from __future__ import annotations

import argparse
import importlib
import sys
import traceback

from repro_torch.device import resolve_device

MODULES = [
    "repro_torch.paper.table1_lvm",
    "repro_torch.paper.table2_llm",
    "repro_torch.paper.table3_overhead",
    "repro_torch.paper.fig4b_tokens",
    "repro_torch.paper.fig7_combinations",
    "repro_torch.paper.table4_sites",
    "repro_torch.paper.fig3_energy",
]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print("name,us_per_call,derived")
    failed = []
    for name in MODULES:
        try:
            for row in importlib.import_module(name).run(device=dev):
                print(f"{row['name']},{row['us_per_call']:.1f},"
                      f"\"{row['derived']}\"", flush=True)
        except Exception:       # report the module, run the others
            failed.append(name)
            traceback.print_exc()
    if failed:
        print(f"FAILED: {failed}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()

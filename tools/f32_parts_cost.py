#!/usr/bin/env python3
"""What f32 row-parallel parts would cost the split training step: the
dry run's ``train_4k`` cell on the production 16 x 16 mesh (fake
tensors, no card) with the training step's partial sums kept in bf16,
as it runs, and with them kept in f32 and rounded once after the sum
(``ModelSplit.f32_parts``, as serving keeps them).

    python3 tools/f32_parts_cost.py [ARCH ...]   # default minicpm-2b

Prints one JSON line an arch and setting: dot FLOPs a rank by dtype, the
collective bytes a rank by kind, and the roofline's three terms.
"""

import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import sharding as SH
    from repro_torch.launch import dryrun as DR
    archs = sys.argv[1:] or ["minicpm-2b"]
    plain = SH.ShardingPolicy.model_split
    for arch in archs:
        for f32 in (False, True):
            def split(self, f32=f32):
                s = plain(self)
                return s if s is None else dataclasses.replace(
                    s, f32_parts=f32)
            SH.ShardingPolicy.model_split = split
            rec = DR.analyze(DR.lower_cell(arch, "train_4k",
                                           multi_pod=False))
            st, rl = rec["op_stats"], rec["roofline"]
            print(json.dumps(dict(
                arch=arch, f32_parts=f32,
                dot_flops_by_dtype=st["dot_flops_by_dtype"],
                collective_bytes=st["collective_bytes_per_device"],
                collective_bytes_by_kind=st["collective_bytes_by_kind"],
                compute_s=rl["compute_s"], memory_s=rl["memory_s"],
                collective_s=rl["collective_s"],
                bottleneck=rl["bottleneck"])), flush=True)
    SH.ShardingPolicy.model_split = plain


if __name__ == "__main__":
    main()

"""Roofline terms for an NVIDIA H100 SXM5 from the dry-run records, the
port of ``repro.analysis.roofline`` (whose constants are a TPU v5e's).

    compute term    = Σ dot FLOPs of a dtype / that dtype's peak
                      + elementwise FLOPs / the f32 CUDA-core peak
    memory term     = HBM bytes / HBM bandwidth
    collective term = collective bytes / network bandwidth per GPU

All inputs from :mod:`repro_torch.analysis.opstats` are *per device* (one
rank's eager program), so the terms are seconds a step on that rank.
MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) for training, 2·N·D
for prefill and 2·N per decoded token, D = tokens processed.

The constants are datasheet peaks (NVIDIA H100 Tensor Core GPU datasheet,
SXM5 column; dense, i.e. without the 2:4 sparsity factor), for an NVIDIA
H100 80GB HBM3 at 700 W.  They are not measurements.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig, ShapeConfig

# NVIDIA H100 80GB HBM3, 700 W (datasheet, SXM5, dense)
PEAK_FLOPS = 989.4e12        # bf16 / fp16 tensor-core FLOP/s
PEAK_INT8_OPS = 1978.9e12    # int8 tensor-core OP/s
PEAK_F32_FLOPS = 66.9e12     # fp32 CUDA-core FLOP/s (no TF32: PyTorch's
#                              default keeps f32 matmuls in full f32)
HBM_BW = 3.35e12             # bytes/s, HBM3
# A 256-rank mesh spans 32 eight-GPU nodes, so a collective over it runs
# at the per-GPU network rate: one InfiniBand NDR port, 400 Gb/s.  (Inside
# one node NVLink 4 gives 450 GB/s a direction, 900 GB/s both ways.)
NET_BW = 50e9                # bytes/s per GPU, InfiniBand NDR 400 Gb/s

# each product's rate by the dtype of its operands (opstats'
# ``dot_flops_by_dtype``); fp16 and fp8 are not on the port's path
DOT_PEAK = {"bf16": PEAK_FLOPS, "f16": PEAK_FLOPS, "f32": PEAK_F32_FLOPS,
            "int8": PEAK_INT8_OPS}


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    hlo_flops_per_device: float
    useful_ratio: float          # MODEL_FLOPS / (dot FLOPs × chips)
    step_time_s: float           # max of the three terms
    roofline_fraction: float     # compute term / step time (→1 = compute-bound)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N·D convention (N = active params, D = tokens)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def compute_roofline(
    op_stats: dict,
    cfg: ModelConfig,
    shape: ShapeConfig,
    chips: int,
) -> Roofline:
    flops_dev = (op_stats["dot_flops_per_device"]
                 + op_stats.get("elem_flops_per_device", 0.0))
    # each dtype's products at its peak (all at the bf16 peak when the
    # record has no split), the elementwise work at the f32 one
    by = op_stats.get("dot_flops_by_dtype") or {
        "bf16": op_stats["dot_flops_per_device"]}
    compute_s = (sum(v / DOT_PEAK[k] for k, v in by.items())
                 + op_stats.get("elem_flops_per_device", 0.0)
                 / PEAK_F32_FLOPS)
    memory_s = op_stats["hbm_bytes_per_device"] / HBM_BW
    collective_s = op_stats["collective_bytes_per_device"] / NET_BW

    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    total = op_stats["dot_flops_per_device"] * chips
    useful = mf / total if total else 0.0
    step = max(terms.values())
    frac = compute_s / step if step else 0.0
    return Roofline(
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=bottleneck, model_flops=mf,
        hlo_flops_per_device=flops_dev, useful_ratio=useful,
        step_time_s=step, roofline_fraction=frac)


def summarize(r: Roofline) -> dict:
    return {
        "compute_s": r.compute_s,
        "memory_s": r.memory_s,
        "collective_s": r.collective_s,
        "bottleneck": r.bottleneck,
        "model_flops": r.model_flops,
        "useful_flops_ratio": r.useful_ratio,
        "step_time_s": r.step_time_s,
        "roofline_fraction": r.roofline_fraction,
    }

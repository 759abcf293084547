"""Multi-pod dry run of the port: trace every (arch × shape × mesh) cell on
fake tensors, the port of ``repro.launch.dryrun``.

Records what the port's own eager step computes, allocates and
communicates on one rank of the reference's production meshes, without
hardware:

* a ``"fake"`` process group of 256 or 512 ranks (no peers exist; its
  collectives move nothing) and the production mesh over it
  (:func:`repro_torch.launch.mesh.make_production_mesh`: ``16 × 16`` or
  ``2 × 16 × 16``);
* the step under ``FakeTensorMode`` (shapes, no storage) with the
  production policy's placement: the trainer's step
  (:func:`repro_torch.launch.train.build_step`: ``train_loss``'s backward,
  then AdamW in place) for train shapes, ``lm.prefill`` /
  ``lm.decode_step`` under :func:`repro_torch.launch.specs.
  make_serve_config` for serve shapes (no fused kernel: like the
  reference's, the dry run reaches none);
* counted op by op by :class:`repro_torch.analysis.opstats.OpCounter`
  (FLOPs, bytes, collectives, peak memory on rank 0) and rooflined
  against an H100 (:mod:`repro_torch.analysis.roofline`);
* a JSON record per cell under ``experiments/dryrun_torch/``, with the
  gzip-compressed op log beside it (``reanalyze`` re-derives the numbers
  from it).

Parameters are stored by the rule table and gathered at use.  The train
step and the serving steps split the model axis's compute
(``ShardingPolicy.model_split``): each model rank keeps its block of the
linears, the vocabulary and the experts, computes the attention heads
its block overlaps, and copy-in / reduce-out collectives make the
function the one-process one; serving's row-parallel STaMP sites
all-reduce their per-token min / max, and the decode cache's sequence is
split as the reference's ``cache_shardings`` / ``decode_kv_spec`` split
it (each rank its block; the partial softmax states gathered and
merged); a Mamba mixer computes its heads (``in_proj`` by parts, the SSD
over its heads, ``out_proj`` row-parallel) and holds their SSM state and
conv cache.  Each record's ``model_split`` names what splits.
Activations split only the batch, and a spec that splits anything else
is refused (``--seq-sharded`` writes a ``refused`` record with the
step's words).

The stand-ins are fake tensors on ``cuda`` where PyTorch is built with
CUDA (no card is needed).  A CPU-only PyTorch cannot index a fake
``cuda`` tensor (its Python indexing takes a CUDA device guard), so
there they are fake ``cpu`` tensors: the same ops, less the host-to-device
copies of host-built constants.  The record's ``device`` says which.

Usage:  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch \\
            qwen2-72b --shape train_4k [--multi-pod] [--seq-sharded] \\
            [--tag name]
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import pathlib
import time
from typing import Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import tree as TR
from repro_torch.analysis import opstats as OS
from repro_torch.analysis import roofline as rl
from repro_torch.configs import get_config, get_reduced
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.train import build_step
from repro_torch.models import lm
from repro_torch.models.config import (SHAPES, ModelConfig, ShapeConfig,
                                       shape_applicable)
from repro_torch.optim import AdamWConfig
from repro_torch.sharding import PartitionSpec as P
from repro_torch.sharding import ShardingPolicy, local

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"


def fake_device() -> torch.device:
    """``cuda:0`` where PyTorch is built with CUDA, else ``cpu``."""
    return torch.device("cuda", 0) if torch.backends.cuda.is_built() \
        else torch.device("cpu")


def _fake_group(world: int) -> bool:
    """A ``"fake"`` process group of ``world`` ranks (this process is rank
    0); returns whether it was made here.  A group already up must be a
    fake one at least that large."""
    import torch.distributed._tools.fake_collectives  # noqa: F401
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() < world:
            raise RuntimeError(
                f"the dry run needs a fake group of {world} ranks; "
                f"{dist.get_backend()} x {dist.get_world_size()} is up")
        return False
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=world)
    return True


def _mesh(mesh_shape: Optional[tuple], multi_pod: bool, device_type: str):
    """The production mesh, or a ``mesh_shape`` one over the last of
    ``("pod", "data", "model")``, for stand-ins of ``device_type`` (a
    DTensor's block moves onto its mesh's device type)."""
    if mesh_shape is None:
        return make_production_mesh(multi_pod=multi_pod,
                                     device_type=device_type)
    from torch.distributed.device_mesh import DeviceMesh
    names = ("pod", "data", "model")[-len(mesh_shape):]
    n = torch.Size(mesh_shape).numel()
    return DeviceMesh(device_type, torch.arange(n).reshape(mesh_shape),
                      mesh_dim_names=names)


def _local_inputs(batch: dict, policy: Optional[ShardingPolicy],
                  global_batch: int, device) -> tuple:
    """Rank 0's rows of the stand-in batch (its block under
    ``batch_shardings``) and those shardings' specs."""
    if policy is None:
        return batch, {}
    sh = S.batch_shardings(batch, policy, global_batch)
    out = {k: torch.empty(S.local_shape(sh[k], v.shape, policy),
                          dtype=v.dtype, device=device)
           for k, v in batch.items()}
    return out, {k: repr(s.spec) for k, s in sh.items()}


def _specs_by_name(tree, shardings, policy, local_tree) -> dict:
    """``{leaf name: {"reference": spec, "port": what this rank holds}}``
    for a cache tree (this rank's rows, the sequence whole) and this
    rank's block of it, one entry a leaf name: the port's split leaves
    (the sequence's, the Mamba state's heads and conv cache's channels)
    name the reference's spec and their block's shape (scales and zero
    points ride with their codes: the hi block's rows, then the lo
    block's)."""
    out = {}
    for (path, leaf), sh, mine in zip(TR.flatten_with_paths(tree),
                                      TR.leaves(shardings),
                                      TR.leaves(local_tree)):
        name = str(path[-1])
        if name in out:
            continue
        port = repr(S.eager_spec(sh.spec, policy))
        if tuple(mine.shape) != tuple(leaf.shape):
            port = (f"{sh.spec!r}: block {tuple(mine.shape)} of "
                    f"{tuple(leaf.shape)}")
            if name.endswith(("_scale", "_zp")):
                port += " (the rows of this rank's hi and lo blocks)"
            if name == "conv":
                port += (" by parts: this rank's x channels and the whole "
                         "B and C, [x block | B | C] (the reference's "
                         "block is a slice of the flat conv_dim)")
        out[name] = {"reference": repr(sh.spec), "port": port}
    return out


def _port_kv_spec(policy: ShardingPolicy, shape: ShapeConfig) -> str:
    """The decode cache's placement in the port, as a spec of its (b, s,
    kv, hd) view: the batch over the batch axes (replicated where the
    global batch is smaller), the sequence over the seq group's axes
    (context parallel)."""
    group = policy.seq_group(shape.global_batch)
    if group is None:
        return "whole on each rank (one rank over the sequence axes)"
    small = group.size != group.model_size
    spec = P(None if small else policy.batch_axes,
             (*policy.batch_axes, "model") if small else "model",
             None, None)
    return (f"{spec!r}: the sequence split over {group.size} ranks (each "
            f"cache region over what divides it), each rank attending "
            f"over its block, the partial softmax states gathered and "
            f"merged in rank order")


def _check_device(tree, device) -> None:
    """Every stand-in's block on ``device`` (the counter counts only
    that device's traffic)."""
    off = [TR.path_name(p) for p, t in TR.flatten_with_paths(tree)
           if local(t).device != device]
    if off:
        raise RuntimeError(f"{len(off)} stand-ins are off {device}, "
                           f"e.g. {off[:3]}")


def _nbytes(tree) -> int:
    return sum(local(t).numel() * local(t).element_size()
               for t in TR.leaves(tree) if isinstance(t, torch.Tensor))


def _alias_bytes(outputs, arguments) -> int:
    """Bytes of the outputs that are arguments updated in place."""
    args = {local(t).untyped_storage()._cdata for t in TR.leaves(arguments)
            if isinstance(t, torch.Tensor)}
    return sum(local(t).numel() * local(t).element_size()
               for t in TR.leaves(outputs) if isinstance(t, torch.Tensor)
               and local(t).untyped_storage()._cdata in args)


def model_split_record(cfg: ModelConfig, shape: ShapeConfig,
                       policy: Optional[ShardingPolicy]) -> dict:
    """What the traced step splits along ``model`` (the record's
    ``model_split``; its ``whole``, what would be computed whole on every
    model rank, is empty)."""
    split = policy is not None and policy.model_split() is not None
    specs = cfg.layer_specs()
    if not split:
        return {"split": False, "why": "no policy" if policy is None
                else "the model axis has one rank"}
    if shape.kind == "train":
        parts = ["embedding and loss (vocab-parallel)"]
    else:
        parts = ["embedding and logits (vocab-parallel; the logits "
                 "gathered whole on every model rank)"]
        if any(s.mixer in ("attn", "mamba") or s.ffn in ("mlp",
                                                         "moe_dense")
               for s in specs):
            parts += ["STaMP at row-parallel sites (per-token min / max "
                      "all-reduced over model before the quantize; "
                      "column-parallel sites quantize the whole, "
                      "replicated rows)"]
    if any(s.mixer == "attn" for s in specs):
        parts += ["attention projections (column / row parallel)",
                  "attention over the heads a rank's block overlaps"]
    if any(s.ffn in ("mlp", "moe_dense") for s in specs) or \
            cfg.encoder_layers:
        parts.append("dense MLP (column / row parallel)")
    if any(s.ffn in ("moe", "moe_dense") for s in specs):
        parts.append("experts (expert parallel; every row routed on "
                     "every rank)")
    if cfg.encoder_layers:
        parts.append("encoder and cross-attention")
    if shape.kind == "decode" and any(s.mixer == "attn" for s in specs):
        parts.append("decode attention context-parallel over the cache's "
                     "sequence (each rank its block; partial softmax "
                     "states gathered and merged in rank order)")
    if any(s.mixer == "mamba" for s in specs):
        parts.append("Mamba mixers over their heads (in_proj column-"
                     "parallel by parts [z | x | B | C | dt], B and C "
                     "whole; conv and SSD over the rank's channels and "
                     "heads; the gated norm's per-head sums of squares "
                     "gathered; out_proj row-parallel)")
        if shape.kind != "train":
            parts.append("Mamba cache: each rank's heads' SSM state and "
                         "its channels' conv cache [x block | B | C]")
    return {"split": True, "model_ranks": policy.model_split().size,
            "split_parts": parts, "whole": []}


def trace_step(cfg: ModelConfig, shape: ShapeConfig,
               policy: Optional[ShardingPolicy], device, *,
               quantize_acts: bool = True, weight_bits=4,
               bf16_params: bool = False) -> dict:
    """Trace one step of ``shape`` on rank 0 under ``policy`` (``None``:
    one device) on fake tensors.  Returns the counter and the record's
    memory and placement fields; raises what the eager step raises."""
    device = torch.device(device)
    info: dict = {"notes": [],
                  "model_split": model_split_record(cfg, shape, policy)}
    if cfg.num_experts:
        info["notes"].append(
            "moe_ffn computes every expert (of this rank's block, under "
            "a model split) under fake tensors (no routing counts to "
            "read): the eager step's work when every expert keeps a "
            "token")
    if shape.kind == "decode" and any(
            s.mixer == "attn" for s in cfg.layer_specs()):
        info["notes"].append(
            "kvcache.write_token writes every row past the hi region under "
            "fake tensors (no position to read): a token at this cell's "
            "cache length")
    with FakeTensorMode():
        batch = S.input_specs(cfg, shape, device)
        batch, info["batch_specs"] = _local_inputs(
            batch, policy, shape.global_batch, device)
        if shape.kind == "train":
            opt_cfg = AdamWConfig()
            params = S.param_struct(cfg, torch.bfloat16 if bf16_params
                                    else torch.float32, device)
            if policy is not None:
                params = policy.place(params, device)
            opt = S.opt_struct(params, opt_cfg)
            for leaf in TR.leaves(params):
                leaf.requires_grad_(True)
            step = build_step(cfg, policy, opt_cfg, False)
            err = {"_": torch.zeros((), device=device)}
            args = (params, opt, err, batch)

            def run():
                return step(*args)
        else:
            serve = S.make_serve_config(cfg, quantize_acts=quantize_acts,
                                        weight_bits=weight_bits)
            serve = dataclasses.replace(serve, cache_capacity=shape.seq_len)
            params = S.serve_param_struct(cfg, serve.weight_bits, device)
            if policy is not None:
                params = policy.place(params, device)
            if shape.kind == "prefill":
                args = (params, batch)

                def run():
                    with torch.no_grad():
                        return lm.prefill(params, batch, cfg, serve,
                                          policy=policy,
                                          global_batch=shape.global_batch)
            else:
                cache = S.cache_struct(cfg, shape, serve, device,
                                       batch=batch["tokens"].shape[0],
                                       policy=policy)
                if policy is not None:
                    whole = S.cache_struct(cfg, shape, serve, device,
                                           batch=batch["tokens"].shape[0])
                    info["cache_specs"] = _specs_by_name(
                        whole, S.cache_shardings(whole, policy,
                                                 shape.global_batch),
                        policy, cache)
                    info["decode_kv_spec"] = {
                        "reference": repr(policy.decode_kv_spec(
                            shape.global_batch)),
                        "port": _port_kv_spec(policy, shape)}
                args = (params, cache, batch)

                def run():
                    with torch.no_grad():
                        return lm.decode_step(params, cache,
                                              batch["tokens"], batch["pos"],
                                              cfg, serve, policy=policy,
                                              global_batch=shape.global_batch)
        _check_device(args, device)
        counter = OS.OpCounter(device)
        arg_bytes = counter.track(args)
        t0 = time.time()
        with counter:
            out = run()
        info["t_trace"] = time.time() - t0
        info["memory"] = {
            "argument_bytes_per_device": arg_bytes,
            "output_bytes_per_device": _nbytes(out),
            "temp_bytes_per_device": counter.peak_bytes - arg_bytes,
            "alias_bytes_per_device": _alias_bytes(out, args),
            "peak_bytes_per_device": counter.peak_bytes,
        }
    info["counter"] = counter
    return info


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               seq_sharded: bool = False, quantize_acts: bool = True,
               weight_bits=4, remat: bool = True,
               serve_replicated_weights: bool = False,
               bf16_params: bool = False, cfg: Optional[ModelConfig] = None,
               shape: Optional[ShapeConfig] = None,
               mesh_shape: Optional[tuple] = None,
               sharded: bool = True, device=None) -> dict:
    """Trace one cell.  The reference's arguments, and: ``cfg`` /
    ``shape`` in place of the registry's (a reduced config, a cut shape),
    ``mesh_shape`` in place of the production mesh (``(2, 4)`` over
    ``("data", "model")``), ``sharded=False`` for one device without a
    policy, ``device`` for the stand-ins (default :func:`fake_device`).
    The train step always recomputes each layer in the backward
    (``train_loss``), as the reference's does whatever ``remat`` says."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"status": "skipped", "reason": why}
    device = torch.device(device) if device is not None else fake_device()
    made = False
    policy = None
    chips = 1
    try:
        if sharded:
            n = torch.Size(mesh_shape).numel() if mesh_shape else \
                (512 if multi_pod else 256)
            made = _fake_group(n)
            mesh = _mesh(mesh_shape, multi_pod, device.type)
            chips = mesh.size()
            policy = ShardingPolicy(
                mesh=mesh, multi_pod=multi_pod, seq_sharded=seq_sharded,
                serve_replicated_weights=(serve_replicated_weights
                                          and shape.kind == "decode"))
        try:
            info = trace_step(cfg, shape, policy, device,
                              quantize_acts=quantize_acts,
                              weight_bits=weight_bits,
                              bf16_params=bf16_params)
        except NotImplementedError as e:
            if not seq_sharded:
                raise
            return {"status": "refused", "reason": str(e)}
    finally:
        if made:
            dist.destroy_process_group()
    return {"status": "ok", "cfg": cfg, "shape": shape, "chips": chips,
            "device": f"{device} (fake)",
            "mesh": None if policy is None else dict(
                zip(policy.mesh.mesh_dim_names, policy.mesh.shape)),
            **info}


def analyze(result: dict, save_ops: str = "") -> dict:
    counter = result["counter"]
    log = counter.log()
    stats = OS.op_stats(log)
    roof = rl.compute_roofline(stats, result["cfg"], result["shape"],
                               result["chips"])
    record = {
        "status": "ok",
        "chips": result["chips"],
        "mesh": result["mesh"],
        "device": result["device"],
        "t_trace_s": round(result["t_trace"], 1),
        "memory": result["memory"],
        "op_stats": stats,
        "roofline": rl.summarize(roof),
        "op_count": stats["device_ops"],
        "decomposed_ops": counter.decomposed,
        "batch_specs": result["batch_specs"],
        "model_split": result["model_split"],
        "notes": result["notes"],
    }
    for k in ("cache_specs", "decode_kv_spec"):
        if k in result:
            record[k] = result[k]
    if save_ops:
        with gzip.open(save_ops, "wt") as f:
            json.dump(log, f)
        record["op_log_path"] = save_ops
    return record


def record_stem(args: argparse.Namespace) -> str:
    """A cell's file name stem: ``{arch}_{shape}_{mesh}`` and a suffix
    for each variant flag."""
    mesh_tag = "multipod" if args.multi_pod else "singlepod"
    stem = f"{args.arch}_{args.shape}_{mesh_tag}"
    for flag, suffix in ((args.seq_sharded, "_sp"),
                         (args.no_stamp, "_nostamp"),
                         (args.reduced, "_reduced")):
        if flag:
            stem += suffix
    if args.tag:
        stem += f"_{args.tag}"
    return stem


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--seq-sharded", action="store_true",
                    help="sequence-parallel residual stream (perf variant; "
                         "the eager step refuses it)")
    ap.add_argument("--no-stamp", action="store_true",
                    help="disable STaMP activation quantization in serving")
    ap.add_argument("--weight-bits", type=int, default=4)
    ap.add_argument("--serve-replicated-weights", action="store_true")
    ap.add_argument("--bf16-params", action="store_true",
                    help="store parameters in bf16 (f32 Adam moments)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--save-ops", action="store_true",
                    help="write the gzip-compressed op log beside the "
                         "record")
    ap.add_argument("--out-dir", default="")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's smoke-test-sized config")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    out_dir = pathlib.Path(args.out_dir) if args.out_dir else OUT_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = record_stem(args)

    t0 = time.time()
    result = lower_cell(
        args.arch, args.shape, multi_pod=args.multi_pod,
        seq_sharded=args.seq_sharded,
        quantize_acts=not args.no_stamp,
        weight_bits=args.weight_bits or None,
        serve_replicated_weights=args.serve_replicated_weights,
        bf16_params=args.bf16_params,
        cfg=get_reduced(args.arch) if args.reduced else None)
    if result["status"] != "ok":
        record = dict(result, t_s=time.time() - t0)
    else:
        ops_path = str(out_dir / f"{stem}.ops.json.gz") \
            if args.save_ops else ""
        record = analyze(result, save_ops=ops_path)
        record.update(arch=args.arch, shape=args.shape,
                      reduced=args.reduced, t_s=time.time() - t0)

    out = out_dir / f"{stem}.json"
    out.write_text(json.dumps(record, indent=2, default=str))
    if record["status"] != "ok":
        print(f"{record['status'].upper()}: {record['reason']}")
    else:
        print(json.dumps(record["memory"], indent=2))
        print(json.dumps(record["roofline"], indent=2))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Can two ranks share one CUDA card?  Each collective the sharded
training step uses, run by two ranks on card 0, one torchrun launch a
collective (a crash then names its collective):

    python3 tools/probe_gloo_cuda.py            # on a machine with a card

gloo on CUDA tensors: ``all_reduce`` (sum and max), ``all_gather_into_
tensor``, ``reduce_scatter_tensor``, ``barrier``, ``scatter``; DTensor's
``distribute_tensor`` (a scatter from rank 0), a gather of blocks placed
with ``from_local`` (the step's placement), the same with its
gradient's reduce-scatter (the step's FSDP pattern), and the pattern from
``distribute_tensor``; NCCL's ``all_reduce`` with both ranks on the one
card.  Prints one line a probe:
the launch's exit code and each rank's result or the error it raised.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

PROBES = [("gloo", op) for op in (
    "all_reduce_sum", "all_reduce_max", "all_gather_into_tensor",
    "reduce_scatter_tensor", "barrier", "scatter", "distribute_tensor",
    "dtensor_gather", "dtensor_gather_grad", "dtensor_fsdp")] + \
    [("nccl", "all_reduce_sum")]


def rank_main(backend: str, op: str) -> None:
    import torch
    import torch.distributed as dist
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group(backend, rank=rank, world_size=world)
    print(f"[rank {rank}] {backend} {op}: calling", flush=True)
    try:
        if op.startswith("all_reduce"):
            t = torch.full((5,), float(rank + 1), device=dev)
            dist.all_reduce(t, op=dist.ReduceOp.MAX if op.endswith("max")
                            else dist.ReduceOp.SUM)
            got = float(t[0])
        elif op == "all_gather_into_tensor":
            out = torch.empty(2 * 4, device=dev)
            dist.all_gather_into_tensor(out, torch.full((4,), float(rank),
                                                        device=dev))
            got = out.tolist()
        elif op == "reduce_scatter_tensor":
            out = torch.empty(4, device=dev)
            dist.reduce_scatter_tensor(out, torch.arange(8., device=dev))
            got = out.tolist()
        elif op == "barrier":
            dist.barrier()
            got = "passed"
        elif op == "scatter":
            out = torch.empty(4, device=dev)
            parts = list(torch.arange(8., device=dev).chunk(2)) \
                if rank == 0 else None
            dist.scatter(out, parts, src=0)
            got = out.tolist()
        else:
            from torch.distributed.device_mesh import DeviceMesh
            from torch.distributed.tensor import (DTensor, Partial,
                                                  Replicate, Shard,
                                                  distribute_tensor)
            mesh = DeviceMesh("cuda", torch.arange(world).reshape(world, 1),
                              mesh_dim_names=("data", "model"))
            torch.manual_seed(0)
            w_full = torch.randn(8, 6, device=dev)
            x = torch.randn(4, 8, device=dev)
            pl = [Shard(0), Replicate()]
            if op in ("distribute_tensor", "dtensor_fsdp"):
                # the scatter from rank 0 that distribute_tensor makes
                w = distribute_tensor(w_full, mesh, pl)
            else:
                # the step's placement: each rank slices its own block
                w = DTensor.from_local(w_full[rank * 4:(rank + 1) * 4],
                                       mesh, pl, run_check=False)
            w = w.detach().requires_grad_(True)
            if op == "distribute_tensor":
                got = list(w.to_local().shape)
            elif op == "dtensor_gather":
                with torch.no_grad():
                    err = (w.full_tensor() - w_full).abs().max()
                got = f"max err {float(err):.2e}"
            else:
                wf = w.full_tensor(grad_placements=[Partial(), Replicate()])
                y = (x[rank * 2:(rank + 1) * 2] @ wf).square().sum()
                g, = torch.autograd.grad(y, [w])
                err = (g.full_tensor() - 2 * x.T @ (x @ w_full)).abs().max()
                got = f"max err {float(err):.2e}"
        torch.cuda.synchronize()
        print(f"[rank {rank}] {backend} {op}: {got}", flush=True)
    except Exception as e:      # the probe reports what the backend raised
        print(f"[rank {rank}] {backend} {op}: {type(e).__name__}: "
              f"{str(e).splitlines()[-1][:240]}", flush=True)
    finally:
        dist.destroy_process_group()


def main() -> None:
    for backend, op in PROBES:
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", __file__, backend, op],
            capture_output=True, text=True, timeout=180)
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("[rank")]
        signal = [ln.strip() for ln in p.stderr.splitlines()
                  if "Signal" in ln or "exitcode" in ln][:2]
        print(f"[probe] {backend} {op}: exit {p.returncode} in "
              f"{time.perf_counter() - t0:.1f}s; {lines}; {signal}",
              flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3:
        rank_main(*sys.argv[1:])
    else:
        main()

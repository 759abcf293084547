"""Meshes over the process group, the port of ``repro.launch.mesh``.

Functions, not module-level constants: importing this module starts no
process group.  The ``model`` axis doubles as the expert-parallel axis on
MoE configs (:mod:`repro_torch.sharding` places the expert stacks with
their expert dim over ``model``).

The group comes from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``)
through :func:`init_distributed`, whose backend the device decides: NCCL
with a card for each rank, gloo on the CPU.  Nothing falls back from one
to the other.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import resolve_device


def launched() -> bool:
    """Whether torchrun (or another launcher) set this process's rank."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_distributed(device=None) -> torch.device:
    """Join the group torchrun's environment describes; returns this
    rank's device.  ``cuda`` (the default) takes the card
    ``LOCAL_RANK`` over NCCL and refuses more ranks a host than cards
    (NCCL refuses two ranks on one card); ``cpu`` takes gloo."""
    dev = resolve_device(device)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if dev.type == "cuda":
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
        cards = torch.cuda.device_count()
        if local_world > cards:
            raise RuntimeError(
                f"{local_world} ranks on this host but {cards} CUDA "
                f"card(s): NCCL takes one card a rank")
        torch.cuda.set_device(local_rank)
        dev = torch.device("cuda", local_rank)
        dist.init_process_group("nccl", rank=rank, world_size=world,
                                device_id=dev)
    elif dev.type == "cpu":
        dist.init_process_group("gloo", rank=rank, world_size=world)
    else:
        raise ValueError(f"no process-group backend for device {dev}")
    return dev


def _mesh(device_type: str, shape: tuple, names: tuple) -> DeviceMesh:
    """A mesh over the group's first ``prod(shape)`` ranks."""
    n, world = torch.Size(shape).numel(), dist.get_world_size()
    if world < n:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the group has "
                         f"{world}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu") -> DeviceMesh:
    """``(16, 16)`` over ``("data", "model")``, or ``(2, 16, 16)`` over
    ``("pod", "data", "model")``, over the group's first 256 or 512 ranks
    (as ``jax.make_mesh`` takes the first devices).  Built under a fake
    group of that size for shapes alone, as the dry run lowers on fake
    host devices; ``device_type`` is its tensors' (DTensor moves a block
    onto its mesh's device type)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, axes)


def make_local_mesh(model_parallel: int = 1, device=None) -> DeviceMesh:
    """``(world / model_parallel, model_parallel)`` over ``("data",
    "model")`` over the process group (one process without a group is a
    world of one).  ``model_parallel`` must divide the world, as the
    reference asserts."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"--model-parallel {model_parallel} does not "
                         f"divide the {world} rank(s) of the group")
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh needs a process group: "
                           "launch with torchrun (init_distributed)")
    return _mesh(resolve_device(device).type,
                 (world // model_parallel, model_parallel),
                 ("data", "model"))

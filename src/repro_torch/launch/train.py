"""The port's training entry point, the port of ``repro.launch.train``:
sharded over the process group's mesh, fault tolerant.

* a ``(world / mp, mp)`` ``("data", "model")`` mesh over the process
  group whenever one is up (``--model-parallel`` sets ``mp``), with the
  reference's sharding rules (:mod:`repro_torch.sharding`): parameters,
  gradients and AdamW moments stored as the rule table places them, each
  leaf gathered over the batch axis at use (its ``model`` block kept
  where the step splits that axis), every rank drawing the same global
  batch and keeping its data rows; without a group (a plain ``python -m``) the
  one-device step, unchanged;
* WSD or cosine schedule (per arch: MiniCPM trains with WSD);
* checkpoint / restart: atomic async checkpoints every ``--ckpt-every``
  steps and a resume equal to the clean run (the data iterator's state
  included); ``--fail-at-step`` injects a hard crash to exercise it;
* elastic restore: a restart may bring up another mesh (or none) — the
  checkpoint holds full leaves and each rank keeps its blocks at load;
* straggler watchdog: steps slower than µ + 4σ of the recent ones are
  logged;
* optional int8 gradient compression with error feedback
  (``--compress-grads``).

No atomics reach the step's sums (the embedding's gradient is
accumulated by PyTorch's sorted index kernel, the loss's gather takes one
label a row, the MoE dispatch and combine are einsums), so no
deterministic mode is set: ``tools/train_determinism.py`` found a resumed
run equal to a clean one bit for bit on an NVIDIA H100 80GB HBM3
(700.00 W) for reduced minicpm-2b, arctic-480b and mamba2-1.3b at 2 x 64
tokens a step; the encoder stacks and full widths were not checked.
Runs on ``cuda`` unless ``--device`` says otherwise; under torchrun a
rank takes the card ``LOCAL_RANK`` over NCCL, or gloo with ``--device
cpu``.  With ``--model-parallel`` above 1 the step splits the model
axis's compute (``lm.train_loss`` under ``ShardingPolicy.model_split``):
column / row-parallel linears, attention over each rank's heads, a
vocab-parallel embedding and loss, expert-parallel MoE, and each Mamba
mixer over the rank's heads.

Usage (CPU, reduced config; one process, then a 2 x 2 mesh):
    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
        --reduced --device cpu --steps 50 --global-batch 8 --seq 256 \\
        --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 4 -m repro_torch.launch.train --device cpu \\
        --model-parallel 2 --arch minicpm-2b --reduced --steps 50 \\
        --global-batch 8 --seq 256 --ckpt-dir /tmp/ckpt
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pathlib
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as TR
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, get_reduced
from repro_torch.data.pipeline import DataConfig, DataIterator
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import init_distributed, launched, make_local_mesh
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               make_schedule)
from repro_torch.optim.compression import (error_feedback_update,
                                           init_error_state)
from repro_torch.sharding import ShardingPolicy


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    global_batch: int = 8
    seq: int = 256
    lr: float = 3e-4
    warmup: int = 20
    ckpt_every: int = 20
    log_every: int = 10
    compress_grads: bool = False
    fail_at_step: int = -1
    model_parallel: int = 1
    seed: int = 0


def build_step(cfg: ModelConfig, policy, opt_cfg: AdamWConfig,
               compress: bool):
    """``step(params, opt_state, err_state, batch) → (params, opt_state,
    err_state, {"loss", "grad_norm", "lr"})``: the loss and its gradients,
    the error-feedback round trip when ``compress``, then AdamW (the
    parameters and moments updated in place).  ``params`` leaves require
    grad.  Under a sharding ``policy`` the parameters and states are
    DTensors placed by its rules (:meth:`ShardingPolicy.place`), ``batch``
    is this rank's rows (:meth:`ShardingPolicy.batch_rows`), and the loss
    and metrics are the global batch's, alike on every rank.  A
    sequence-sharded policy is refused: only the dry run sets it."""
    if policy is not None and policy.seq_sharded:
        raise NotImplementedError(
            "the eager step splits only the batch: seq_sharded is the dry "
            "run's policy")

    def step(params, opt_state, err_state, batch):
        flat = TR.leaves(params)
        loss = lm.train_loss(params, batch, cfg, policy)
        grads = TR.unflatten_like(params, torch.autograd.grad(loss, flat))
        if compress:
            grads, err_state = error_feedback_update(grads, err_state)
        params, opt_state, metrics = adamw_update(grads, opt_state, params,
                                                  opt_cfg)
        return params, opt_state, err_state, {"loss": loss.detach(),
                                              **metrics}
    return step


def _trainable(params):
    for leaf in TR.leaves(params):
        leaf.requires_grad_(True)
    return params


def train(cfg: ModelConfig, tc: TrainConfig, ckpt_dir: Optional[str] = None,
          verbose: bool = True, device=None) -> dict:
    """Train from the seeded init (``lm.init_params(cfg, tc.seed)``, f32)
    for ``tc.steps`` steps of :class:`DataIterator` batches, resuming from
    the newest checkpoint in ``ckpt_dir``.  With a process group up, on
    the ``(world / tc.model_parallel, tc.model_parallel)`` mesh, every
    leaf placed by the reference's rules; rank 0 prints.  Without one, a
    ``model_parallel`` above 1 raises, as the reference's assertion does
    on one device.  Returns ``{"params", "opt_state", "losses",
    "step_times"}`` (DTensor leaves on a mesh)."""
    dev = resolve_device(device)
    policy = None
    if dist.is_initialized() or tc.model_parallel != 1:
        policy = ShardingPolicy(mesh=make_local_mesh(tc.model_parallel, dev))
    lead = not dist.is_initialized() or dist.get_rank() == 0
    verbose = verbose and lead
    sched = make_schedule(cfg.schedule, tc.lr, tc.warmup, tc.steps)
    opt_cfg = AdamWConfig(lr=tc.lr, schedule=sched)

    params = lm.init_params(cfg, tc.seed, device=dev)
    params_sh = opt_sh = None
    if policy is not None:
        params_sh = policy.params_shardings(params)
        opt_sh = {"step": None, "m": params_sh, "v": params_sh}
        params = policy.place(params, dev)
    opt_state = adamw_init(params, opt_cfg)
    err_state = (init_error_state(params) if tc.compress_grads
                 else {"_": torch.zeros((), device=dev)})
    step_fn = build_step(cfg, policy, opt_cfg, tc.compress_grads)

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=tc.seq,
                      global_batch=tc.global_batch, seed=tc.seed)
    data = DataIterator(dcfg)

    mgr = CheckpointManager(pathlib.Path(ckpt_dir)) if ckpt_dir else None
    start_step = 0
    if mgr is not None and mgr.latest_step() is not None:
        state, extra = mgr.restore({"params": params, "opt": opt_state},
                                   shardings={"params": params_sh,
                                              "opt": opt_sh},
                                   device=dev)
        params, opt_state = state["params"], state["opt"]
        data.restore(extra["data"])
        start_step = int(extra["step"])
        if verbose:
            print(f"[restore] resumed from step {start_step}", flush=True)
    params = _trainable(params)

    losses = []
    step_times = []
    for step in range(start_step, tc.steps):
        if step == tc.fail_at_step:
            if mgr is not None:
                # the async writer is a separate failure domain: a compute
                # crash must not lose an already-initiated checkpoint write
                # (otherwise resume is timing-dependent); every rank waits
                # for rank 0's writer
                mgr.wait()
            if lead:
                print(f"[fault] injected failure at step {step}", flush=True)
            os._exit(17)        # hard crash: no atexit, no new checkpoint
        t0 = time.time()
        batch = next(data)
        if policy is not None:
            batch = policy.batch_rows(batch)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        params, opt_state, err_state, metrics = step_fn(
            params, opt_state, err_state, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        step_times.append(dt)
        losses.append(loss)
        # straggler watchdog
        if len(step_times) > 10:
            mu = float(np.mean(step_times[-50:-1]))
            sd = float(np.std(step_times[-50:-1]) + 1e-9)
            if verbose and dt > mu + 4 * sd and dt > 1.5 * mu:
                print(f"[straggler] step {step} took {dt:.2f}s "
                      f"(µ={mu:.2f}s σ={sd:.2f}s) — flagged for "
                      f"reallocation", flush=True)
        if verbose and step % tc.log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f}ms", flush=True)
        if mgr is not None and (step + 1) % tc.ckpt_every == 0:
            mgr.save_async(step + 1, {"params": params, "opt": opt_state},
                           extra={"step": step + 1, "data": data.state()})
    if mgr is not None:
        mgr.wait()
        mgr.save(tc.steps, {"params": params, "opt": opt_state},
                 extra={"step": tc.steps, "data": data.state()})
    return {"params": params, "opt_state": opt_state, "losses": losses,
            "step_times": step_times}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--fail-at-step", type=int, default=-1)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    tc = TrainConfig(steps=args.steps, global_batch=args.global_batch,
                     seq=args.seq, lr=args.lr, ckpt_every=args.ckpt_every,
                     compress_grads=args.compress_grads,
                     fail_at_step=args.fail_at_step,
                     model_parallel=args.model_parallel)
    device = args.device
    joined = launched() and not dist.is_initialized()
    if joined:
        device = init_distributed(device)
    try:
        out = train(cfg, tc, ckpt_dir=args.ckpt_dir or None, device=device)
        if not dist.is_initialized() or dist.get_rank() == 0:
            print(f"final loss: {out['losses'][-1]:.4f} "
                  f"(first: {out['losses'][0]:.4f})")
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()

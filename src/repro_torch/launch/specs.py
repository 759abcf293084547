"""Fake-tensor stand-ins and shardings for every dry-run cell, the port of
``repro.launch.specs``.

The reference's ``jax.ShapeDtypeStruct`` stand-ins become fake tensors:
every function here that makes one runs under the caller's
``FakeTensorMode`` (a storage-free tensor of the given shape, dtype and
device; nothing is allocated) and refuses to run without it.  The tree
builders call the port's own init, packing and cache code, so a
stand-in's shape is the one the step would get.  Shardings are the
port's :class:`~repro_torch.sharding.NamedSharding` s with the
reference's specs; :func:`eager_spec` is the part of a spec the eager
step holds (the batch split alone).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch import tree as TR
from repro_torch.core.stamp import StampConfig
from repro_torch.device import fake_mode_active
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.serving.kvcache import KVCacheConfig
from repro_torch.sharding import (NamedSharding, PartitionSpec,
                                  ShardingPolicy, axis_size)

Pytree = Any
P = PartitionSpec


def _need_fake() -> None:
    if not fake_mode_active():
        raise RuntimeError("dry-run stand-ins are fake tensors: call under "
                           "torch._subclasses.fake_tensor.FakeTensorMode")


def _sds(shape, dtype, device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, device) -> dict:
    """Stand-ins for the data inputs of one (arch × shape) cell."""
    _need_fake()
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": _sds((b,), torch.int32, device),
                "pos": _sds((), torch.int32, device)}
    batch: dict = {}
    if cfg.frontend == "patch":
        s_txt = s - cfg.num_patches
        batch["tokens"] = _sds((b, s_txt), torch.int32, device)
        batch["patches"] = _sds((b, cfg.num_patches, cfg.d_model),
                                torch.bfloat16, device)
    else:
        batch["tokens"] = _sds((b, s), torch.int32, device)
    if cfg.frontend == "frames" or cfg.encoder_layers:
        batch["frames"] = _sds((b, max(s // cfg.frame_ratio, 1),
                                cfg.d_model), torch.bfloat16, device)
    if shape.kind == "train":
        batch["labels"] = _sds((b, s), torch.int32, device)
    return batch


def _data_size(policy: ShardingPolicy) -> int:
    return axis_size(policy.mesh, policy.batch_axes)


def batch_shardings(batch: dict, policy: ShardingPolicy,
                    global_batch: Optional[int] = None) -> dict:
    ba = policy.batch_axes
    if global_batch is not None and global_batch < _data_size(policy):
        ba = None   # tiny batch (long-context decode): replicate it
    out = {}
    for k, v in batch.items():
        if v.ndim == 0:
            out[k] = policy.named(P())
        elif v.ndim == 1:
            out[k] = policy.named(P(ba))
        elif v.ndim == 2:
            out[k] = policy.named(P(ba, None))
        else:
            out[k] = policy.named(P(ba, None, None))
    return out


def param_struct(cfg: ModelConfig, dtype=torch.float32,
                 device="cuda") -> Pytree:
    _need_fake()
    return lm.init_params(cfg, 0, device=device, dtype=dtype)


def serve_param_struct(cfg: ModelConfig, weight_bits: Optional[int] = 4,
                       device="cuda") -> Pytree:
    """bf16 parameters with every layer's large matmul weights packed to
    ``weight_bits`` (the encoder's too), as the reference packs its
    whole tree."""
    p = param_struct(cfg, torch.bfloat16, device)
    if weight_bits:
        pack = lambda layers: [lm.quantize_weights_for_serving(  # noqa: E731
            q, weight_bits) for q in layers]
        p["layers"] = pack(p["layers"])
        if "encoder" in p:
            p["encoder"] = dict(p["encoder"],
                                layers=pack(p["encoder"]["layers"]))
    return p


def opt_struct(params: Pytree, opt_cfg: AdamWConfig) -> Pytree:
    _need_fake()
    return adamw_init(params, opt_cfg)


def opt_shardings(opt_struct_tree: Pytree, params_sh: Pytree,
                  policy: ShardingPolicy) -> Pytree:
    return {
        "step": policy.named(P()),
        "m": params_sh,
        "v": params_sh,
    }


def cache_struct(cfg: ModelConfig, shape: ShapeConfig,
                 serve: lm.ServeConfig, device="cuda",
                 batch: Optional[int] = None,
                 policy: Optional[ShardingPolicy] = None) -> Pytree:
    """The contiguous decode cache of ``shape`` (``batch`` rows, default
    the global batch) as stand-ins; under a ``policy`` this rank's block
    of its sequence (:meth:`ShardingPolicy.seq_group`, the reference's
    ``cache_shardings``) and of its Mamba layers' heads and channels
    (:meth:`ShardingPolicy.model_split`: the state's block is the
    reference's, the conv cache's is ``[x block | B | C]`` where the
    reference splits the flat conv_dim)."""
    _need_fake()
    group = split = None
    if policy is not None:
        group = policy.seq_group(shape.global_batch)
        split = policy.model_split()
    return lm.init_cache(cfg, shape.global_batch if batch is None
                         else batch, shape.seq_len, serve, device=device,
                         group=group, split=split)


_SEQ_KEYS = ("k_hi", "v_hi", "k_lo", "v_lo", "k", "v", "xk", "xv")
_SCALE_KEYS = ("k_scale", "k_zp", "v_scale", "v_zp")


def cache_shardings(cache: Pytree, policy: ShardingPolicy,
                    global_batch: Optional[int] = None) -> Pytree:
    """The reference's specs for the cache's leaves (the port's leaves
    lack the stacked period axis, so a spec has no leading ``None`` for
    it)."""
    ba = policy.batch_axes
    seq_pref = ("model",)
    if global_batch is not None and global_batch < _data_size(policy):
        # long-context decode (batch=1): context-parallel over ALL axes —
        # the cache sequence is the only parallel dimension left.
        seq_pref = tuple(ba) + ("model",)
        ba = None

    def fit_seq(dim: int):
        """Largest seq sharding that divides `dim` (the 64-token hi region
        of the mixed-precision cache is tiny — replicate if needed)."""
        if dim % axis_size(policy.mesh, seq_pref) == 0:
            return seq_pref
        if dim % axis_size(policy.mesh, "model") == 0:
            return "model"
        return None

    def spec_for(path, leaf):
        name = str(path[-1])
        nd = leaf.dim()
        if name in _SEQ_KEYS:           # (..., b, s, kv, hd)
            base = [ba, fit_seq(leaf.shape[-3]), None, None]
        elif name in _SCALE_KEYS:       # (..., b, s, kv)
            base = [ba, fit_seq(leaf.shape[-2]), None]
        elif name == "state":           # (..., b, h, p, n)
            base = [ba, "model", None, None]
        elif name == "conv":            # (..., b, w, c)
            base = [ba, None, "model"]
        else:
            base = [None] * nd
        lead = nd - len(base)
        return policy.named(P(*([None] * lead), *base))

    flat = TR.flatten_with_paths(cache)
    return TR.unflatten_like(cache, [spec_for(p, t) for p, t in flat])


def eager_spec(spec: PartitionSpec, policy: ShardingPolicy
               ) -> PartitionSpec:
    """The part of ``spec`` the eager step holds: the batch axes' split,
    every other dim whole (:meth:`ShardingPolicy.constraint`)."""
    keep = set(policy.batch_axes)

    def entry(e):
        axes = () if e is None else (e,) if isinstance(e, str) else e
        return tuple(a for a in axes if a in keep)
    return P(*(entry(e) for e in spec))


def local_shape(sh: NamedSharding, shape, policy: ShardingPolicy) -> tuple:
    """Each rank's block shape of a leaf the eager step holds at ``sh``
    (:func:`eager_spec` of its spec)."""
    return NamedSharding(sh.mesh, eager_spec(sh.spec, policy)
                         ).shard_shape(shape)


def make_serve_config(cfg: ModelConfig, quantize_acts: bool = True,
                      weight_bits: Optional[int] = 4) -> lm.ServeConfig:
    stamp = None
    if quantize_acts:
        stamp = StampConfig(seq_transform="dwt", levels=None,  # auto
                            num_hi_tokens=64, skip_first_token=True)
    return lm.ServeConfig(stamp=stamp, kv=KVCacheConfig(quantized=True),
                          weight_bits=weight_bits)

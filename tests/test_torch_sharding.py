"""The port's sharding rules (``repro_torch.sharding``) and meshes
(``repro_torch.launch.mesh``) against the reference's
(``repro.sharding``, ``repro.launch.mesh``).

* The rule table leaf by leaf: for every leaf of every arch of
  ``repro_torch.configs.ARCHS`` at its reduced size (carried from the
  reference's init by ``from_jax_params``), and of its int4-packed and
  fused-prepared serve trees, the port's ``param_spec`` equals the
  reference's for the stacked counterpart (``period/j/…`` with its leading
  period axis, ``prologue/i/…``, ``encoder/period/0/…``) minus that
  axis, under the single-pod, multi-pod, multi-pod without FSDP over
  ``pod`` and replicated-serving policies; every spec turns into
  placements on the port's production meshes.
* ``tests/test_distributed.py``'s rule assertions, on the port.
* The production meshes under PyTorch's fake process group (512 ranks,
  no hardware): for every leaf of full-width minicpm-2b and arctic-480b
  (shapes from a fake-tensor init) the local shard shape, from the rule
  table's arithmetic and from DTensor's own, equals the reference's
  ``NamedSharding(mesh, spec).shard_shape`` on 512 forced host devices
  (one subprocess, shapes only); the activation, cache, SSM and decode-KV
  specs equal the reference's on those meshes.
* The refusals: a mesh axis the mesh lacks or out of order, an uneven
  split, ``--model-parallel`` that does not divide the world, a
  sequence-sharded constraint in the eager step.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

jax.config.update("jax_platform_name", "cpu")

from jax.sharding import Mesh
from repro.configs import get_reduced as jget_reduced
from repro.models import lm as JLM
from repro.sharding import ShardingPolicy as JPolicy
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch import sharding as SH
from repro_torch import tree as TR
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.core.stamp import StampConfig
from repro_torch.launch import mesh as MESH
from repro_torch.models import lm as TLM

# One PyTorch thread a process (see test_torch_train.py).
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
P = SH.PartitionSpec
VARIANTS = {"single": dict(),
            "multi": dict(multi_pod=True),
            "multi_no_pod_fsdp": dict(multi_pod=True, fsdp_over_pod=False),
            "serve_replicated": dict(serve_replicated_weights=True)}
ARCH_NAMES = sorted(a.replace("_", "-") for a in ARCHS)
FULL_ARCHS = ("minicpm-2b", "arctic-480b")
DECODE_BATCHES = (1, 8, 16, 31, 32, 64, 512)


@pytest.fixture(scope="module")
def meshes():
    """The port's production meshes over a fake group of 512 ranks."""
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        yield {"single": MESH.make_production_mesh(),
               "multi": MESH.make_production_mesh(multi_pod=True)}
    finally:
        dist.destroy_process_group()


def _port_policy(meshes, variant: str) -> SH.ShardingPolicy:
    kw = VARIANTS[variant]
    mesh = meshes["multi" if kw.get("multi_pod") else "single"]
    return SH.ShardingPolicy(mesh=mesh, **kw)


def _ref_policy(variant: str) -> JPolicy:
    """The reference's policy over a one-device mesh: its rule table
    reads no mesh size."""
    kw = VARIANTS[variant]
    names = ("pod", "data", "model") if kw.get("multi_pod") else \
        ("data", "model")
    mesh = Mesh(np.array(jax.devices()[:1]).reshape((1,) * len(names)),
                names)
    return JPolicy(mesh=mesh, **kw)


def _ref_path(cfg, path: tuple) -> tuple:
    """The reference tree's path of a port leaf, and whether it is stacked
    (a leading period axis): ``layers/i`` is ``prologue/i`` or
    ``period/j`` of the layer plan, ``encoder/layers/i`` is
    ``encoder/period/0``."""
    pro, period, _ = cfg.layer_plan()
    if path[0] == "layers":
        i = path[1]
        if i < len(pro):
            return ("prologue", i, *path[2:]), False
        return ("period", (i - len(pro)) % len(period), *path[2:]), True
    if path[:2] == ("encoder", "layers"):
        return ("encoder", "period", 0, *path[3:]), True
    return path, False


def _name(path: tuple) -> str:
    return "/".join(str(k) for k in path)


def _jax_paths(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf.ndim for path, leaf in flat}


@pytest.fixture(scope="module", params=ARCH_NAMES)
def arch_trees(request):
    """One arch's reduced trees: the reference's init, the port's
    (carried), its int4-packed serve tree and its fused-prepared one."""
    arch = request.param
    jcfg, tcfg = jget_reduced(arch), get_reduced(arch)
    jtree = JLM.init_params(jax.random.PRNGKey(0), jcfg)
    params = TLM.from_jax_params(jax.tree.map(np.asarray, jtree), tcfg)
    packed = dict(params, layers=[TLM.quantize_weights_for_serving(p)
                                  for p in params["layers"]])
    prepared = TLM.prepare_fused_weights(
        dict(params), StampConfig(execution="fused"))
    return dict(arch=arch, cfg=tcfg, ref=_jax_paths(jtree),
                trees={"params": params, "packed": packed,
                       "prepared": prepared})


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_rule_table_leaf_by_leaf(arch_trees, meshes, variant):
    port, ref = _port_policy(meshes, variant), _ref_policy(variant)
    cfg, checked = arch_trees["cfg"], 0
    for kind, tree in arch_trees["trees"].items():
        for path, leaf in TR.flatten_with_paths(tree):
            rpath, stacked = _ref_path(cfg, path)
            rname, ndim = _name(rpath), leaf.dim() + stacked
            if kind == "params":    # the mapping lands on a reference leaf
                assert arch_trees["ref"].get(rname) == ndim, (path, rname)
            want = tuple(ref.param_spec(rname, ndim))
            if stacked:
                assert want[0] is None, (rname, want)
                want = want[1:]
            got = port.param_spec(TR.path_name(path), leaf.dim())
            assert tuple(got) == want, (kind, path, got, want)
            SH.placements(port.mesh, got)
            checked += 1
    assert checked > len(arch_trees["ref"])


def test_distributed_rules_on_the_port(meshes):
    """``tests/test_distributed.py``'s ``TestShardingRules``, on the port
    (its stacked paths as they are, and their unrolled twins)."""
    policy = SH.ShardingPolicy(mesh=meshes["single"])
    cases = [("period/0/wq", 3, P(None, "data", "model")),
             ("period/0/wo", 3, P(None, "model", "data")),
             ("embed", 2, P("model", "data")),
             ("period/0/we_gate", 4, P(None, "model", "data", None)),
             ("period/0/ln1", 2, P(None, None)),
             ("period/0/wq/q", 3, P(None, "data", "model")),
             ("period/0/wq/scale", 3, P(None, None, "model")),
             ("period/0/wq/iq", 3, P(None, "data", "model")),
             ("period/0/wqkv/iq", 3, P(None, "data", "model")),
             ("period/0/wqkv/isw", 3, P(None, None, "model")),
             ("period/0/wo_mlp/iq", 3, P(None, "model", "data")),
             ("period/0/wq/isw", 3, P(None, None, "model")),
             ("period/0/wq/izw", 3, P(None, None, "model")),
             ("layers/3/wq", 2, P("data", "model")),
             ("layers/3/we_gate", 3, P("model", "data", None)),
             ("layers/3/wq/scale", 2, P(None, "model"))]
    for path, ndim, want in cases:
        assert policy.param_spec(path, ndim) == want, path
    seq = SH.ShardingPolicy(mesh=meshes["single"], seq_sharded=True)
    assert seq.acts() == P(("data",), "model", None) == \
        P("data", "model", None)


def test_placements(meshes):
    multi = meshes["multi"]
    assert SH.placements(multi, P(("pod", "data"), "model")) == \
        (Shard(0), Shard(0), Shard(1))
    assert SH.placements(multi, P(None, "model", "data")) == \
        (Replicate(), Shard(2), Shard(1))
    assert SH.placements(multi, P()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="no axis 'pod'"):
        SH.placements(meshes["single"], P(("pod", "data"), None))
    with pytest.raises(ValueError, match="order"):
        SH.placements(multi, P(("data", "pod"), None))
    with pytest.raises(ValueError, match="twice"):
        SH.placements(multi, P("data", "data"))
    with pytest.raises(ValueError, match="split"):
        SH.NamedSharding(meshes["single"], P("data", None)).shard_shape(
            (24, 4))


def test_refusals(meshes):
    """``--model-parallel`` must divide the world, as the reference
    asserts; the eager step splits only the batch."""
    with pytest.raises(ValueError, match="model-parallel 7"):
        MESH.make_local_mesh(7, "cpu")
    policy = SH.ShardingPolicy(mesh=meshes["single"])
    x = torch.zeros(2, 3, 4)
    assert SH.constrain(x, policy, lambda p: p.acts()) is x
    assert SH.constrain(x, None, lambda p: p.acts()) is x
    seq = SH.ShardingPolicy(mesh=meshes["single"], seq_sharded=True)
    with pytest.raises(NotImplementedError, match="only the batch"):
        SH.constrain(x, seq, lambda p: p.acts())
    with pytest.raises(ValueError, match="does not split"):
        policy.batch_rows({"tokens": np.zeros((24, 8))})
    rows = policy.batch_rows({"tokens": np.arange(32)[:, None]})
    assert rows["tokens"][:, 0].tolist() == [0, 1]     # rank 0's rows


# ---------------------------------------------------------------------------
# shard shapes and activation specs on the production meshes
# ---------------------------------------------------------------------------


REFERENCE_SHAPES = """
import json, jax
from jax.sharding import NamedSharding
from repro.configs import get_config
from repro.launch.mesh import make_production_mesh
from repro.models import lm
from repro.sharding import ShardingPolicy
variants = {variants!r}
meshes = {{m: make_production_mesh(multi_pod=m == "multi")
          for m in ("single", "multi")}}
out = {{}}
for v, kw in variants.items():
    pol = ShardingPolicy(mesh=meshes["multi" if kw.get("multi_pod")
                                     else "single"], **kw)
    specs = {{k: list(getattr(pol, k)()) for k in (
        "tokens", "acts", "frontend_embeds", "kv_cache", "kv_cache_packed",
        "kv_scale", "ssm_state", "conv_cache")}}
    specs["acts_seq"] = list(ShardingPolicy(
        mesh=pol.mesh, seq_sharded=True, **kw).acts())
    specs.update({{f"decode_kv_{{b}}": list(pol.decode_kv_spec(b))
                  for b in {batches!r}}})
    out[v] = {{"specs": specs}}
    for arch in {archs!r}:
        cfg = get_config(arch)
        shapes = jax.eval_shape(lambda: lm.init_params(
            jax.random.PRNGKey(0), cfg))
        flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
        leaves = {{}}
        for path, leaf in flat:
            name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                            for k in path)
            spec = pol.param_spec(name, leaf.ndim)
            leaves[name] = list(NamedSharding(pol.mesh, spec).shard_shape(
                leaf.shape))
        out[v][arch] = leaves
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_shapes():
    code = REFERENCE_SHAPES.format(variants=VARIANTS, batches=DECODE_BATCHES,
                                   archs=FULL_ARCHS)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    p = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def _entries(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_activation_and_cache_specs(meshes, reference_shapes, variant):
    pol = _port_policy(meshes, variant)
    want = reference_shapes[variant]["specs"]
    got = {k: _entries(getattr(pol, k)()) for k in (
        "tokens", "acts", "frontend_embeds", "kv_cache", "kv_cache_packed",
        "kv_scale", "ssm_state", "conv_cache")}
    got["acts_seq"] = _entries(dataclasses.replace(
        pol, seq_sharded=True).acts())
    got.update({f"decode_kv_{b}": _entries(pol.decode_kv_spec(b))
                for b in DECODE_BATCHES})
    assert got == want
    # both branches of decode_kv_spec were taken
    assert want["decode_kv_1"] != want["decode_kv_512"]


@pytest.fixture(scope="module", params=FULL_ARCHS)
def full_width_tree(request):
    """A full-width arch's parameter shapes from the port's own init
    under fake tensors (nothing allocated)."""
    cfg = get_config(request.param)
    with FakeTensorMode():
        params = TLM.init_params(cfg, 0, device="cpu")
    return request.param, cfg, [(p, tuple(t.shape))
                                for p, t in TR.flatten_with_paths(params)]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_local_shard_shapes_on_production_meshes(meshes, reference_shapes,
                                                 full_width_tree, variant):
    arch, cfg, leaves = full_width_tree
    pol = _port_policy(meshes, variant)
    want = reference_shapes[variant][arch]
    for path, shape in leaves:
        rpath, stacked = _ref_path(cfg, path)
        ref = want[_name(rpath)]
        if stacked:
            ref = ref[1:]
        sharding = pol.named(pol.param_spec(TR.path_name(path), len(shape)))
        assert list(sharding.shard_shape(shape)) == ref, (path, shape)
        local, _ = compute_local_shape_and_global_offset(
            shape, pol.mesh, sharding.placements)
        assert list(local) == ref, (path, shape)
    assert len(leaves) >= len(want)

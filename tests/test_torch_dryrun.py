"""The port's dry-run tools (``repro_torch.launch.{specs,dryrun,sweep,
report,reanalyze}``, ``repro_torch.analysis.{opstats,roofline}``) against
the reference's (``repro.launch.*``, ``repro.analysis.*``).

* ``SHAPES`` / ``shape_applicable``, ``param_count`` /
  ``active_param_count`` and ``model_flops`` equal the reference's for
  every arch (and shape).
* The stand-ins at full width: every leaf of ``param_struct``,
  ``serve_param_struct``, ``opt_struct``, ``input_specs`` and
  ``cache_struct`` (fake tensors) has the shape and dtype of the
  reference's ``jax.eval_shape`` counterpart, less its stacked period
  axis; ``batch_shardings`` / ``cache_shardings`` give the reference's
  specs on the production meshes (the port's over a fake 512-rank group,
  the reference's over an ``AbstractMesh`` of the same shape).
* The H100 roofline's arithmetic, as ``tests/test_analysis.py`` checks
  the reference's with TPU constants.
* The op counter: a fake trace's FLOPs, bytes and peak memory equal the
  same counter's on real CPU tensors (reduced minicpm-2b train and
  prefill), and the prefill's dot FLOPs equal the reference's
  ``analyze_hlo_text`` on its compiled CPU program (tolerance 0: both
  run the same products — per layer the q, k, v, o, gate, up and down
  projections and attention's score and value einsums over every
  2048-token chunk pair — and the head on the last position).
* On a ``(2, 4)`` fake mesh the train step's all-gathers equal what the
  rule table predicts leaf by leaf (over ``data`` only: the split step
  keeps the ``model`` blocks) plus the split's k / v gathers, and its
  residual- and loss-sized all-reduces what the layer structure names;
  the reference's small-mesh cells trace ``ok`` on 8 ranks; ``--seq-sharded`` is refused with the eager
  step's words; ``sweep`` over two reduced cells, ``report`` and
  ``reanalyze`` round-trip.
"""

import dataclasses
import json
import math
import shutil

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

jax.config.update("jax_platform_name", "cpu")

from jax.sharding import AbstractMesh
from repro.analysis import hlo as JH
from repro.analysis import roofline as JRL
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.launch import specs as JS
from repro.models import lm as JLM
from repro.models.config import SHAPES as JSHAPES
from repro.models.config import shape_applicable as jshape_applicable
from repro.optim import AdamWConfig as JAdamWConfig
from repro.sharding import ShardingPolicy as JPolicy
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Shard

from repro_torch import sharding as SH
from repro_torch import tree as TR
from repro_torch.analysis import opstats as OS
from repro_torch.analysis import roofline as RL
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as MESH
from repro_torch.launch import reanalyze as RA
from repro_torch.launch import report as RP
from repro_torch.launch import specs as S
from repro_torch.launch import sweep as SW
from repro_torch.launch.train import build_step
from repro_torch.models import lm as TLM
from repro_torch.models.config import SHAPES, ShapeConfig, shape_applicable
from repro_torch.optim import AdamWConfig, adamw_init

# One PyTorch thread a process (see test_torch_train.py).
torch.set_num_threads(1)

ARCH_NAMES = sorted(a.replace("_", "-") for a in ARCHS)
CPU = torch.device("cpu")
# the reference's small-mesh cells (tests/test_distributed.py:265-268)
SMALL_CELLS = [("minicpm-2b", "train_4k"), ("mamba2-1.3b", "decode_32k")]
SMALL_MESH = (2, 4)


def _small(shape_name: str) -> ShapeConfig:
    return dataclasses.replace(SHAPES[shape_name], seq_len=256,
                               global_batch=4)


# ---------------------------------------------------------------------------
# configs, shapes, model FLOPs
# ---------------------------------------------------------------------------


def test_shapes_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    assert SHAPES["decode_32k"].is_decode and \
        not SHAPES["train_4k"].is_decode
    for arch in ARCH_NAMES:
        for name in SHAPES:
            assert shape_applicable(get_config(arch), SHAPES[name]) == \
                jshape_applicable(jget_config(arch), JSHAPES[name]), \
                (arch, name)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_counts_and_model_flops(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    for name in SHAPES:
        assert RL.model_flops(cfg, SHAPES[name]) == \
            JRL.model_flops(jcfg, JSHAPES[name]), name


# ---------------------------------------------------------------------------
# stand-ins at full width
# ---------------------------------------------------------------------------


def _ref_path(cfg, path: tuple) -> tuple:
    """A port leaf's reference path and whether it is stacked (see
    tests/test_torch_sharding.py): ``layers/i`` is ``prologue/i`` or
    ``period/j``; ``encoder/layers/i`` is ``encoder/period/0``; a cache's
    entry ``i`` is ``pro{i}`` or ``{j}``; ``m`` / ``v`` moments keep their
    parameter's mapping."""
    pro, period, _ = cfg.layer_plan()
    if path[0] in ("m", "v"):
        rest, stacked = _ref_path(cfg, path[1:])
        return (path[0], *rest), stacked
    if path[0] == "layers":
        i = path[1]
        if i < len(pro):
            return ("prologue", i, *path[2:]), False
        return ("period", (i - len(pro)) % len(period), *path[2:]), True
    if path[:2] == ("encoder", "layers"):
        return ("encoder", "period", 0, *path[3:]), True
    return path, False


def _cache_ref_path(cfg, path: tuple) -> tuple:
    pro, period, _ = cfg.layer_plan()
    i = path[0]
    if i < len(pro):
        return (f"pro{i}", *path[1:]), False
    return (str((i - len(pro)) % len(period)), *path[1:]), True


def _jax_leaves(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf for path, leaf in flat}


def _same_leaves(port, ref, mapping) -> int:
    """Every port leaf has its reference leaf's shape (less the stacked
    axis) and dtype; every reference leaf is reached."""
    want = _jax_leaves(ref)
    seen = set()
    for path, leaf in TR.flatten_with_paths(port):
        rpath, stacked = mapping(path)
        name = "/".join(str(k) for k in rpath)
        assert name in want, (path, name)
        r = want[name]
        shape = tuple(r.shape[1:] if stacked else r.shape)
        assert tuple(leaf.shape) == shape, (path, leaf.shape, shape)
        assert str(leaf.dtype)[6:] == str(np.dtype(r.dtype)), \
            (path, leaf.dtype, r.dtype)
        seen.add(name)
    assert seen == set(want)
    return len(seen)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_stand_ins_at_full_width(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    pmap = lambda p: _ref_path(cfg, p)             # noqa: E731
    with FakeTensorMode():
        params = S.param_struct(cfg, device=CPU)
        _same_leaves(params, JS.param_struct(jcfg), pmap)
        opt = S.opt_struct(params, AdamWConfig())
        jopt = JS.opt_struct(JS.param_struct(jcfg), JAdamWConfig())
        _same_leaves(opt, jopt, pmap)
        _same_leaves(S.serve_param_struct(cfg, 4, CPU),
                     JS.serve_param_struct(jcfg, 4), pmap)
        serve, jserve = S.make_serve_config(cfg), JS.make_serve_config(jcfg)
        assert serve.stamp.num_hi_tokens == jserve.stamp.num_hi_tokens == 64
        assert serve.weight_bits == jserve.weight_bits == 4
        for name, shape in SHAPES.items():
            if not shape_applicable(cfg, shape)[0]:
                continue
            _same_leaves(S.input_specs(cfg, shape, CPU),
                         JS.input_specs(jcfg, JSHAPES[name]),
                         lambda p: (p, False))
            if shape.kind == "decode":
                _same_leaves(S.cache_struct(cfg, shape, serve, CPU),
                             JS.cache_struct(jcfg, JSHAPES[name], jserve),
                             lambda p: _cache_ref_path(cfg, p))


@pytest.fixture
def meshes():
    """The port's production meshes over a fake group of 512 ranks, and
    the reference's as abstract meshes of the same shapes."""
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=512)
    try:
        yield {False: (MESH.make_production_mesh(),
                       AbstractMesh((16, 16), ("data", "model"))),
               True: (MESH.make_production_mesh(multi_pod=True),
                      AbstractMesh((2, 16, 16), ("pod", "data", "model")))}
    finally:
        dist.destroy_process_group()


def _spec(s) -> tuple:
    return tuple(tuple(e) if isinstance(e, (tuple, list)) and len(e) > 1
                 else e[0] if isinstance(e, (tuple, list)) and e else
                 None if isinstance(e, (tuple, list)) else e for e in s)


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["singlepod", "multipod"])
def test_batch_and_cache_shardings(meshes, multi_pod):
    mesh, jmesh = meshes[multi_pod]
    pol = SH.ShardingPolicy(mesh=mesh, multi_pod=multi_pod)
    jpol = JPolicy(mesh=jmesh, multi_pod=multi_pod)
    checked = 0
    for arch in ARCH_NAMES:
        cfg, jcfg = get_config(arch), jget_config(arch)
        serve, jserve = S.make_serve_config(cfg), JS.make_serve_config(jcfg)
        for name, shape in SHAPES.items():
            if not shape_applicable(cfg, shape)[0]:
                continue
            gb = shape.global_batch
            with FakeTensorMode():
                batch = S.input_specs(cfg, shape, CPU)
                cache = S.cache_struct(cfg, shape, serve, CPU) \
                    if shape.kind == "decode" else None
            got = S.batch_shardings(batch, pol, gb)
            want = JS.batch_shardings(JS.input_specs(jcfg, JSHAPES[name]),
                                      jpol, gb)
            for k in batch:
                assert _spec(got[k].spec) == _spec(want[k].spec), (arch, k)
                checked += 1
            if cache is None:
                continue
            got = S.cache_shardings(cache, pol, gb)
            want = _jax_leaves(JS.cache_shardings(
                JS.cache_struct(jcfg, JSHAPES[name], jserve), jpol, gb))
            for (path, _), sh in zip(TR.flatten_with_paths(cache),
                                     TR.leaves(got)):
                rpath, stacked = _cache_ref_path(cfg, path)
                w = _spec(want["/".join(map(str, rpath))].spec)
                if stacked:
                    assert w[0] is None
                    w = w[1:]
                assert _spec(sh.spec) == w, (arch, name, path)
                SH.placements(mesh, sh.spec)
                eager = S.eager_spec(sh.spec, pol)
                assert all(a in pol.batch_axes for e in eager
                           for a in SH._axes(e))
                checked += 1
    assert checked > 500


# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------


def test_roofline_terms_on_the_h100():
    assert (RL.PEAK_FLOPS, RL.PEAK_INT8_OPS, RL.HBM_BW, RL.NET_BW) == \
        (989.4e12, 1978.9e12, 3.35e12, 50e9)
    for tpu in (197e12, 819e9):            # v5e's bf16 peak and HBM rate
        assert tpu not in vars(RL).values()
    stats = {
        "dot_flops_per_device": RL.PEAK_FLOPS,   # exactly 1 s of compute
        "elem_flops_per_device": 0.0,
        "hbm_bytes_per_device": RL.HBM_BW * 2,   # 2 s of memory
        "collective_bytes_per_device": RL.NET_BW * 0.5,
        "collective_bytes_by_kind": {}, "collective_counts": {},
    }
    cfg = get_config("qwen2-72b")
    r = RL.compute_roofline(stats, cfg, SHAPES["train_4k"], 256)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(2.0)
    assert r.collective_s == pytest.approx(0.5)
    assert r.bottleneck == "memory"
    assert r.step_time_s == pytest.approx(2.0)
    assert r.roofline_fraction == pytest.approx(0.5)
    assert r.useful_ratio == pytest.approx(
        RL.model_flops(cfg, SHAPES["train_4k"]) / (RL.PEAK_FLOPS * 256))
    # each product at its dtype's peak, elementwise work at the f32 one
    split = dict(stats, dot_flops_by_dtype={
        "bf16": RL.PEAK_FLOPS, "int8": 2 * RL.PEAK_INT8_OPS,
        "f32": RL.PEAK_F32_FLOPS}, elem_flops_per_device=RL.PEAK_F32_FLOPS)
    r = RL.compute_roofline(split, cfg, SHAPES["train_4k"], 256)
    assert r.compute_s == pytest.approx(5.0)
    assert r.bottleneck == "compute" and r.roofline_fraction == 1.0
    assert set(RL.summarize(r)) == set(JRL.summarize(
        JRL.compute_roofline(stats, jget_config("qwen2-72b"),
                             JSHAPES["train_4k"], 256)))


# ---------------------------------------------------------------------------
# the op counter: fake against real, and against the reference's HLO
# ---------------------------------------------------------------------------

RCFG = get_reduced("minicpm-2b")
TRAIN = ShapeConfig("train_small", 64, 2, "train")
PREFILL = ShapeConfig("prefill_small", 256, 2, "prefill")
# past one 2048-token attention chunk: the chunked walk
PREFILL_LONG = ShapeConfig("prefill_long", 4096, 1, "prefill")


def _fake(shape: ShapeConfig) -> dict:
    r = DR.lower_cell("minicpm-2b", None, multi_pod=False, cfg=RCFG,
                      shape=shape, sharded=False, device=CPU)
    assert r["status"] == "ok" and r["chips"] == 1
    return r


def _real_counts(shape: ShapeConfig):
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, RCFG.vocab_size, (shape.global_batch,
                                                shape.seq_len),
                           generator=gen, dtype=torch.int32)
    if shape.kind == "train":
        params = TLM.init_params(RCFG, 0, device=CPU)
        opt = adamw_init(params, AdamWConfig())
        for leaf in TR.leaves(params):
            leaf.requires_grad_(True)
        batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
        args = (params, opt, {"_": torch.zeros(())}, batch)
        step = build_step(RCFG, None, AdamWConfig(), False)
        run = lambda: step(*args)                   # noqa: E731
    else:
        params = TLM.init_params(RCFG, 0, device=CPU, dtype=torch.bfloat16)
        params["layers"] = [TLM.quantize_weights_for_serving(p, 4)
                            for p in params["layers"]]
        batch = {"tokens": tokens}
        args = (params, batch)
        serve = S.make_serve_config(RCFG)

        def run():
            with torch.no_grad():
                return TLM.prefill(params, batch, RCFG, serve)
    counter = OS.OpCounter(CPU)
    arg_bytes = counter.track(args)
    with counter:
        run()
    return counter, arg_bytes


@pytest.mark.parametrize("shape", [TRAIN, PREFILL], ids=lambda s: s.kind)
def test_fake_trace_counts_equal_real_tensors(shape):
    fake = _fake(shape)
    real, real_args = _real_counts(shape)
    got = OS.op_stats(fake["counter"].log())
    want = OS.op_stats(real.log())
    for k in ("dot_flops_per_device", "hbm_bytes_per_device",
              "elem_flops_per_device", "dot_flops_by_dtype", "device_ops"):
        assert got[k] == want[k], k
    assert got["dot_flops_per_device"] > 0 and got["collective_counts"] == {}
    assert fake["memory"]["argument_bytes_per_device"] == real_args
    assert fake["memory"]["peak_bytes_per_device"] == real.peak_bytes
    # the counter's FLOPs are FlopCounterMode's on the same step
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        _real_counts(shape)
    assert fc.get_total_flops() == got["dot_flops_per_device"]


def test_prefill_dot_flops_against_the_reference_hlo():
    jcfg = jget_reduced("minicpm-2b")
    jshape = JSHAPES["prefill_32k"].__class__(
        PREFILL_LONG.name, PREFILL_LONG.seq_len, PREFILL_LONG.global_batch,
        "prefill")
    serve = JS.make_serve_config(jcfg)
    text = jax.jit(lambda p, b: JLM.prefill(p, b, jcfg, serve)).lower(
        JS.serve_param_struct(jcfg, 4),
        JS.input_specs(jcfg, jshape)).compile().as_text()
    want = JH.analyze_hlo_text(text)["dot_flops_per_device"]
    got = OS.op_stats(_fake(PREFILL_LONG)["counter"].log())
    assert got["dot_flops_per_device"] == want
    # attention over 2 x 2 chunk pairs dominates: its two einsums per
    # layer in f32, 2·(2·4096·4096·32)·4 heads·4 layers
    assert got["dot_flops_by_dtype"]["f32"] == 2 * 2 * 4096 ** 2 * 32 * 16


# ---------------------------------------------------------------------------
# sharded cells on small fake meshes
# ---------------------------------------------------------------------------


def _expected_gathers(cfg, policy) -> tuple:
    """From the rule table: each leaf gathered over the batch axis only
    (the split step keeps its ``model`` block), twice a step inside a
    layer (the forward and the recompute), once outside (``embed``,
    ``head``, ``final_norm``).  Returns (all-gathers, their output bytes,
    the bytes they receive)."""
    with FakeTensorMode():
        params = S.param_struct(cfg, device=CPU)
    mesh = policy.mesh
    names = mesh.mesh_dim_names
    n = out_b = recv_b = 0
    for path, leaf in TR.flatten_with_paths(params):
        spec = policy.param_spec(TR.path_name(path), leaf.dim())
        pl = SH.placements(mesh, spec)
        times = 2 if path[0] in ("layers", "encoder") else 1
        shape = list(policy.named(spec).shard_shape(leaf.shape))
        block = math.prod(shape)
        for i in reversed(range(mesh.ndim)):
            if isinstance(pl[i], Shard) and mesh.size(i) > 1 and \
                    names[i] != "model":
                shape[pl[i].dim] *= mesh.size(i)
                n += times
                out_b += times * math.prod(shape) * leaf.element_size()
        recv_b += times * (math.prod(shape) - block) * leaf.element_size()
    return n, out_b, recv_b


def _expected_activation_collectives(cfg, shape, policy) -> dict:
    """From the layer structure of the split step (each layer run twice,
    its forward and its recompute; the loss's one chunk twice): per
    attention layer and pass the gathers of k and v over ``model`` (and
    of q where a rank's block is not whole heads); the residual-sized
    all-reduces — per layer the attention's reduce-out in both passes and
    the FFN's in the forward only (the recompute stops at the last tensor
    the backward needs, and the FFN's sum is the layer's last op), once a
    step the embedding's, and in the backward each layer's two copy-ins
    and the loss input's; and the loss's per pass three ``(b, chunk)``
    f32 all-reduces (the row max, the sum of exponentials, the gold
    logit)."""
    m = SH.axis_size(policy.mesh, "model")
    b = shape.global_batch // SH.axis_size(policy.mesh, policy.batch_axes)
    s, layers = shape.seq_len, cfg.num_layers
    q_block = cfg.q_dim // m
    per_pass = 2 + (q_block % cfg.resolved_head_dim != 0)
    gathers = 2 * layers * per_pass
    kv_out = b * s * cfg.kv_dim * 2
    out_b = 2 * layers * 2 * kv_out
    recv_b = 2 * layers * 2 * (kv_out - kv_out // m)
    if per_pass == 3:
        out_b += 2 * layers * b * s * cfg.q_dim * 2
        recv_b += 2 * layers * b * s * (cfg.q_dim - q_block) * 2
    chunk = min(512, s)
    return {"gathers": (gathers, out_b, recv_b),
            "residual_all_reduces": (3 * layers + 1 + 2 * layers + 1,
                                     b * s * cfg.d_model * 2),
            "loss_all_reduces": (3 * 2 * (s // chunk), b * chunk * 4)}


def test_train_all_gathers_follow_the_rule_table():
    """On a (2, 4) mesh the split step gathers each leaf over ``data``
    only, and gathers k and v over ``model`` in each attention layer; its
    residual-sized and loss-sized all-reduces are those the layer
    structure names."""
    cfg = get_reduced("minicpm-2b")
    shape = _small("train_4k")
    r = DR.lower_cell("minicpm-2b", None, multi_pod=False, cfg=cfg,
                      shape=shape, mesh_shape=SMALL_MESH, device=CPU)
    assert r["status"] == "ok" and r["chips"] == 8
    assert r["model_split"]["split"] and r["model_split"]["whole"] == []
    log = r["counter"].log()
    stats = OS.op_stats(log)
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=8)
    try:
        policy = SH.ShardingPolicy(mesh=DR._mesh(SMALL_MESH, False,
                                                 "cpu"))
        n, out_b, recv_b = _expected_gathers(cfg, policy)
        act = _expected_activation_collectives(cfg, shape, policy)
    finally:
        dist.destroy_process_group()
    an, aout, arecv = act["gathers"]
    assert stats["collective_counts"]["all-gather"] == n + an
    assert stats["collective_bytes_by_kind"]["all-gather"] == out_b + aout
    recv = sum(rec["count"] * (rec["writes"] - rec["reads"]) for rec in log
               if rec.get("coll") == "all-gather")
    assert recv == recv_b + arecv
    for key in ("residual_all_reduces", "loss_all_reduces"):
        count, payload = act[key]
        assert sum(rec["count"] for rec in log
                   if rec.get("coll") == "all-reduce"
                   and rec["payload"] == payload) == count, key
    # the gradients leave as reduce-scatters (sharded leaves) and
    # all-reduces (replicated norms, the loss and norm sums)
    assert stats["collective_counts"]["reduce-scatter"] > 0
    assert stats["collective_counts"]["all-reduce"] > 0


@pytest.mark.parametrize("arch,shape", SMALL_CELLS)
def test_small_mesh_cells_trace_on_8_ranks(arch, shape):
    r = DR.lower_cell(arch, shape, multi_pod=False, cfg=get_reduced(arch),
                      shape=_small(shape), mesh_shape=SMALL_MESH, device=CPU)
    assert r["status"] == "ok", r
    assert r["chips"] == 8 and r["mesh"] == {"data": 2, "model": 4}
    rec = DR.analyze(r)
    assert rec["op_stats"]["dot_flops_per_device"] > 0
    assert rec["memory"]["peak_bytes_per_device"] >= \
        rec["memory"]["argument_bytes_per_device"] > 0
    if shape == "decode_32k":
        # the reference splits the SSM state's heads over model, and so
        # does the eager step (4 of 16 heads a rank); the conv cache's
        # channels split by parts, [x block | B | C], where the
        # reference splits the flat conv_dim
        assert rec["cache_specs"]["state"] == {
            "reference": "P('data', 'model', None, None)",
            "port": "P('data', 'model', None, None): block (2, 4, 16, 16) "
                    "of (2, 16, 16, 16)"}
        conv = rec["cache_specs"]["conv"]
        assert conv["reference"] == "P('data', None, 'model')"
        assert conv["port"].startswith(
            "P('data', None, 'model'): block (2, 3, 96) of (2, 3, 288) by "
            "parts: this rank's x channels and the whole B and C")
    assert not dist.is_initialized()


def test_seq_sharded_is_refused(tmp_path):
    r = DR.lower_cell("minicpm-2b", None, multi_pod=False,
                      cfg=get_reduced("minicpm-2b"),
                      shape=_small("train_4k"), mesh_shape=SMALL_MESH,
                      seq_sharded=True, device=CPU)
    assert r["status"] == "refused"
    assert "seq_sharded" in r["reason"]
    DR.main(["--arch", "minicpm-2b", "--shape", "prefill_32k", "--reduced",
             "--seq-sharded", "--out-dir", str(tmp_path)])
    rec = json.loads((tmp_path / "minicpm-2b_prefill_32k_singlepod_sp_"
                                 "reduced.json").read_text())
    assert rec["status"] == "refused"
    assert "eager step splits only the batch" in rec["reason"]
    assert not dist.is_initialized()


def test_sweep_report_reanalyze_round_trip(tmp_path):
    SW.main(["--archs", "minicpm-2b", "--shapes", "train_4k,decode_32k",
             "--only-singlepod", "--extra=--reduced", "--jobs", "2",
             "--out-dir", str(tmp_path)])
    recs = {}
    for shape in ("train_4k", "decode_32k"):
        p = tmp_path / f"minicpm-2b_{shape}_singlepod_reduced.json"
        recs[shape] = json.loads(p.read_text())
        assert recs[shape]["status"] == "ok", recs[shape]
        assert (tmp_path / f"{p.stem}.ops.json.gz").exists()
    table = RP.roofline_table(tmp_path, "singlepod", "_reduced")
    for shape in ("train_4k", "decode_32k"):
        row = next(line for line in table.splitlines()
                   if f"| minicpm-2b | {shape} |" in line)
        assert "missing" not in row and "ERROR" not in row
        assert f"{recs[shape]['roofline']['compute_s']:.3f}" in row
    assert "minicpm-2b | train_4k | singlepod | 256" in \
        RP.dryrun_table(tmp_path, "_reduced")
    # reanalyze from the op log alone gives the record back
    kept = tmp_path / "kept"
    kept.mkdir()
    for p in tmp_path.glob("*.json"):
        shutil.copy(p, kept / p.name)
    for p in sorted(tmp_path.glob("*_reduced.json")):
        assert RA.reanalyze(p).startswith("ok")
        assert json.loads(p.read_text()) == \
            json.loads((kept / p.name).read_text())
    # a cached cell is not run again
    SW.main(["--archs", "minicpm-2b", "--shapes", "train_4k",
             "--only-singlepod", "--extra=--reduced",
             "--out-dir", str(tmp_path)])

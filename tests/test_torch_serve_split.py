"""The model axis's split of serving (``lm.prefill`` / ``lm.decode_step``
under a ``ShardingPolicy`` whose ``model`` axis has more than one rank) on
the CPU, held against one process and against the reference.

* K1's and K3's plain versions in their statistics modes: each rank's
  block of a row-parallel input gives its rows' ``(min, max)``, the
  ranks' are reduced, and the block quantized with them gives the whole
  rows' codes, scales and zero points for its columns **exactly**
  (``dwt`` and ``wht``, the sink row in and out, every row at 8 bits, a
  span of 200 rows through the span link); K2's plain parts, summed over
  the ranks and finished by its summed mode, give the whole rows' fused
  linear bit for bit.
* K6's plain block mode over 2 and 4 sequence blocks of a cache, the
  blocks' states merged in rank order, against the whole-cache call (an
  empty block and a hi region no block count divides included), and the
  cache's blocks against the whole cache's slices, exactly.
* Prefill and 8 teacher-forced decode steps of reduced llama3-8b (GQA),
  minicpm-2b with 6 heads (1.5 heads a rank on 4 ranks), Arctic
  (experts; its router ×30, as the training tests scale it) and Seamless
  (encoder and cross-attention), in both STaMP executions, on (1, 4),
  (2, 2) and (1, 2) meshes of gloo workers against one process: the
  logits within bounds set from the measured gaps (the prefill's and
  the fused decode's measured 0: a fused site's K2 int32 parts are
  summed exactly before its one epilogue, the other row-parallel parts
  summed in f32 and rounded once), each rank's cache block the one process's bit for
  bit (every layer's in the fused execution, the first layer's in the
  reference execution), greedy tokens equal wherever the one process's
  top-1 / top-2 margin exceeds 0.1.
* Quant telemetry under the split: each site's stats one process's.
* The reference's ``prefill`` / ``decode_step`` under a (1, 4) policy on
  4 forced host devices (reference execution, every row at 8 bits, XLA's
  excess precision off) against the port's (1, 4) split.
* The dry run's fake (1, 4) prefill and decode dot FLOPs equal each real
  gloo rank's ``FlopCounterMode`` count, exactly.

The workers are this file run as a script (a ``FileStore`` under the
module's temporary directory), one PyTorch thread each; their weights are
the reference's ``init_params`` pytree converted once by the test process.
"""

import dataclasses
import os
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

# One PyTorch thread a process (see test_torch_train.py).
torch.set_num_threads(1)

from repro_torch import sharding as SH
from repro_torch.configs import get_reduced
from repro_torch.core.stamp import StampConfig
from repro_torch.kernels import cache_attention as CA
from repro_torch.kernels import decode_matmul as DM
from repro_torch.kernels import stamp_matmul as SM
from repro_torch.models import lm as TLM
from repro_torch.models.config import ShapeConfig
from repro_torch.serving import kvcache as KV

ROOT = Path(__file__).resolve().parents[1]

B, S, CAP, STEPS = 2, 72, 96, 8
ROUTER_SCALE = 30.0
ARCHS = ("llama3-8b", "minicpm-2b", "arctic-480b", "seamless-m4t-large-v2")
EXECUTIONS = ("reference", "fused")
# (world, model ranks): the (1, 4) and (2, 2) meshes share one group of
# four, the (1, 2) mesh is a group of two
MESHES = {(1, 4): (4, 4), (2, 2): (4, 2), (1, 2): (2, 2)}
REF_ARCH = "llama3-8b"          # the reference's (1, 4) run
SMALL = {"prefill": ShapeConfig("prefill_small", S, B, "prefill"),
         "decode": ShapeConfig("decode_small", CAP, B, "decode")}
# measured (max |split − one| / max |one|, every mesh): the prefill's
# logits 0 in both executions and the fused decode steps' 0 (the
# row-parallel parts are summed in f32 and rounded once, as one device
# rounds its product; K1 / K3 / K6's plain versions are exact in their
# new modes); the reference execution's decode steps 0.0166 (dense) and
# 0.134 (Arctic, its ×30 router): its plain segment attention merges the
# ranks' partial softmax states in another order, which moves the next
# token's K / V by a bf16 step and a 4-bit cache code now and then
PREFILL_TOL = 1e-2
DECODE_TOL = {"fused": 1e-2, "reference": 0.03}
MOE_DECODE_TOL = 0.2            # the reference execution's, Arctic
REF_TOL = 0.05                  # against the reference's (1, 4) step:
MARGIN = 0.1                    # measured 0.0279
# the reference execution's cache codes past the first layer: measured at
# most 3.6% differ (minicpm-2b's last layer, (1, 4))
REF_CODE_FLIPS = 0.05


def _rng(tag: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(tag.encode()))


def _cfgs(arch: str) -> tuple:
    """The reference's and the port's reduced configs (minicpm-2b with 6
    heads of 32: 1.5 heads a rank on 4 ranks)."""
    from repro.configs import get_reduced as jget
    jc, tc = jget(arch), get_reduced(arch)
    if arch == "minicpm-2b":
        kw = dict(num_heads=6, num_kv_heads=6, head_dim=32)
        jc, tc = dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)
    return jc, tc


def _stamp(execution: str, bits8: bool = False) -> StampConfig:
    kw = dict(hi_bits=8, lo_bits=8) if bits8 else {}
    return StampConfig(levels=None, execution=execution, **kw)


def _serve(execution: str, bits8: bool = False) -> TLM.ServeConfig:
    kv = KV.KVCacheConfig(hi_bits=8, lo_bits=8) if bits8 else \
        KV.KVCacheConfig()
    fused = execution == "fused"
    return TLM.ServeConfig(stamp=_stamp(execution, bits8), kv=kv,
                           cache_capacity=CAP, fused_cache_attention=fused,
                           fused_decode_matmul=fused)


def _inputs(cfg) -> dict:
    r = _rng(f"inputs/{cfg.name}")
    out = {"tokens": r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "forced": r.integers(0, cfg.vocab_size,
                                (STEPS, B)).astype(np.int32)}
    if cfg.encoder_layers:
        out["frames"] = r.standard_normal(
            (B, S // cfg.frame_ratio, cfg.d_model)).astype(np.float32)
    return out


def _batch(inp: dict, rows=slice(None)) -> dict:
    out = {"tokens": torch.from_numpy(inp["tokens"][rows])}
    if "frames" in inp:
        out["frames"] = torch.from_numpy(inp["frames"][rows])
    return out


def _packed(params: dict) -> dict:
    """The decoder layers' large weights packed to int4, whole."""
    return {**params, "layers": [TLM.quantize_weights_for_serving(p, 4)
                                 for p in params["layers"]]}


def _serve_params(params: dict, cfg, execution: str, split):
    """The whole packed tree, then (fused) prepared from the whole
    weights, as this rank's blocks."""
    packed = _packed(params)
    if execution == "fused":
        return TLM.prepare_fused_weights(packed, _stamp("fused"), split)
    return TLM.model_blocks(packed, split, cfg)


def _run(params, cfg, serve, inp, policy=None, rows=slice(None)) -> dict:
    """Prefill, then ``STEPS`` teacher-forced decode steps: every step's
    logits and the cache after the prefill."""
    with torch.no_grad():
        logits, cache = TLM.prefill(params, _batch(inp, rows), cfg, serve,
                                    policy=policy)
        prefill_cache = [{k: v.clone() for k, v in e.items()}
                         for e in cache]
        out = [logits]
        for i in range(STEPS):
            tok = torch.from_numpy(inp["forced"][i][rows])
            logits, cache = TLM.decode_step(params, cache, tok, S + i, cfg,
                                            serve, policy=policy)
            out.append(logits)
    return {"logits": torch.stack(out), "cache": prefill_cache}


# ---------------------------------------------------------------------------
# the workers
# ---------------------------------------------------------------------------


def _worker(work: Path, world: int, rank: int) -> None:
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch.mesh import make_local_mesh
    dist.init_process_group("gloo", init_method=f"file://{work}/store{world}",
                            rank=rank, world_size=world)
    weights = torch.load(work / "weights.pt")
    out = {}
    try:
        for mesh, (w, mp) in MESHES.items():
            if w != world:
                continue
            policy = SH.ShardingPolicy(mesh=make_local_mesh(mp, "cpu"))
            split = policy.model_split()
            data, n_data = policy._batch_index()
            rows = slice(data * B // n_data, (data + 1) * B // n_data)
            for arch in ARCHS:
                _, cfg = _cfgs(arch)
                inp = _inputs(cfg)
                for ex in EXECUTIONS:
                    params = _serve_params(weights[arch], cfg, ex, split)
                    out[(mesh, arch, ex)] = _run(params, cfg, _serve(ex),
                                                 inp, policy, rows)
            if mesh == (1, 4):
                _, cfg = _cfgs(REF_ARCH)
                params = TLM.model_blocks(weights[REF_ARCH], split, cfg)
                out["reference_8bit"] = _run(
                    params, cfg, _serve("reference", True), _inputs(cfg),
                    policy)
                out["telemetry"] = _telemetry(
                    _serve_params(weights[REF_ARCH], cfg, "fused", split),
                    cfg, _inputs(cfg), policy)
                # the rule table's placement (DTensors gathered with their
                # model blocks) gives the blocks route's numbers
                placed = policy.place(_packed(weights[REF_ARCH]))
                out["placed"] = _run(placed, cfg, _serve("reference"),
                                     _inputs(cfg), policy)
                out["flops"] = {}
                for kind in ("prefill", "decode"):
                    with FlopCounterMode(display=False) as fc:
                        _flop_step(kind, policy)
                    out["flops"][kind] = fc.get_total_flops()
        torch.save(out, work / f"out{world}_{rank}.pt")
    finally:
        dist.destroy_process_group()


def _telemetry(params, cfg, inp, policy=None) -> dict:
    """The prefill's quant-health site stats (fused execution, telemetry
    on)."""
    serve = dataclasses.replace(_serve("fused"), quant_telemetry=True)
    with torch.no_grad():
        _, _, telem = TLM.prefill(params, _batch(inp), cfg, serve,
                                  policy=policy)
    return telem


def _flop_step(kind: str, policy) -> None:
    """The dry run's cell on real tensors: reduced minicpm-2b's packed bf16
    parameters placed by the rule table, ``make_serve_config``'s STaMP, a
    prefill of ``SMALL["prefill"]`` or one decode step over a cache of
    ``SMALL["decode"]``."""
    from repro_torch.launch import specs as LS
    cfg = get_reduced("minicpm-2b")
    shape = SMALL[kind]
    serve = dataclasses.replace(LS.make_serve_config(cfg),
                                cache_capacity=shape.seq_len)
    params = policy.place(_packed(TLM.init_params(cfg, 0, device="cpu",
                                                  dtype=torch.bfloat16)))
    idx, n = policy._batch_index()
    b = shape.global_batch // n
    with torch.no_grad():
        if kind == "prefill":
            tok = torch.zeros((b, shape.seq_len), dtype=torch.int32)
            TLM.prefill(params, tok, cfg, serve, policy=policy,
                        global_batch=shape.global_batch)
        else:
            cache = TLM.init_cache(cfg, b, shape.seq_len, serve, "cpu",
                                   group=policy.seq_group(shape.global_batch))
            TLM.decode_step(params, cache, torch.zeros(b, dtype=torch.int32),
                            shape.seq_len - 1, cfg, serve, policy=policy,
                            global_batch=shape.global_batch)


REFERENCE = """
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
sys.path.insert(0, {tests!r})
import test_torch_serve_split as T
from repro.core.stamp import StampConfig
from repro.launch.mesh import make_local_mesh
from repro.models import lm
from repro.serving import kvcache as KVR
from repro.sharding import ShardingPolicy
jcfg, tcfg = T._cfgs(T.REF_ARCH)
params = lm.init_params(jax.random.PRNGKey(0), jcfg)
policy = ShardingPolicy(mesh=make_local_mesh(4))
serve = lm.ServeConfig(stamp=StampConfig(levels=None, hi_bits=8, lo_bits=8),
                       kv=KVR.KVCacheConfig(hi_bits=8, lo_bits=8),
                       cache_capacity=T.CAP)
sh = policy.params_shardings(params)
params = jax.device_put(params, sh)
inp = T._inputs(tcfg)
logits, cache = jax.jit(lambda p, t: lm.prefill(p, {{"tokens": t}}, jcfg,
                                               serve, policy))(
    params, jnp.asarray(inp["tokens"]))
out = [np.asarray(logits)]
step = jax.jit(lambda p, c, t, pos: lm.decode_step(p, c, t, pos, jcfg, serve,
                                                   policy))
for i in range(T.STEPS):
    logits, cache = step(params, cache, jnp.asarray(inp["forced"][i]),
                         jnp.asarray(T.S + i, jnp.int32))
    out.append(np.asarray(logits))
np.save({out!r}, np.stack(out))
"""


def _env(**extra) -> dict:
    return dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}",
                OMP_NUM_THREADS="1", **extra)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The workers' results, the reference's (1, 4) logits and the one
    process's runs."""
    import jax
    jax.config.update("jax_platform_name", "cpu")
    from repro.models import lm as JLM
    work = tmp_path_factory.mktemp("serve_split")
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE.format(
            tests=str(ROOT / "tests"), out=str(work / "reference.npy"))],
        env=_env(JAX_PLATFORMS="cpu", XLA_FLAGS=(
            "--xla_force_host_platform_device_count=4 "
            "--xla_allow_excess_precision=false")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    weights = {}
    for arch in ARCHS:
        jc, tc = _cfgs(arch)
        tree = jax.tree.map(np.asarray, JLM.init_params(
            jax.random.PRNGKey(0), jc))
        params = TLM.from_jax_params(tree, tc)
        if tc.num_experts:
            for p in params["layers"]:
                if "gate_w" in p:
                    p["gate_w"] = p["gate_w"] * ROUTER_SCALE
        weights[arch] = params
    torch.save(weights, work / "weights.pt")
    workers = [subprocess.Popen(
        [sys.executable, __file__, "worker", str(work), str(world),
         str(r)], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for world in (4, 2) for r in range(world)]
    try:
        one = {}
        for arch in ARCHS:
            _, cfg = _cfgs(arch)
            for ex in EXECUTIONS:
                one[(arch, ex)] = _run(_serve_params(weights[arch], cfg, ex,
                                                     None), cfg, _serve(ex),
                                       _inputs(cfg))
        logs = [w.communicate(timeout=600)[0] for w in workers]
        ref_out, ref_err = ref.communicate(timeout=600)
    finally:
        for p in [*workers, ref]:
            if p.poll() is None:
                p.kill()
    for w, log in zip(workers, logs):
        assert w.returncode == 0, log[-3000:]
    assert ref.returncode == 0, ref_err[-3000:]
    ranks = {world: [torch.load(work / f"out{world}_{r}.pt")
                     for r in range(world)] for world in (4, 2)}
    return {"ranks": ranks, "one": one, "weights": weights,
            "reference": torch.from_numpy(np.load(work / "reference.npy"))}


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) / \
        max(float(want.float().abs().max()), 1e-30)


def _mesh_ranks(runs, mesh) -> list:
    world, _ = MESHES[mesh]
    return runs["ranks"][world]


def _logits(runs, mesh, key) -> torch.Tensor:
    """The mesh's logits, its data ranks' rows in order (every model rank
    of a data rank alike, checked)."""
    world, mp = MESHES[mesh]
    ranks = runs["ranks"][world]
    rows = []
    for d in range(world // mp):
        got = [ranks[d * mp + m][key]["logits"] for m in range(mp)]
        for g in got[1:]:
            assert torch.equal(g, got[0]), "model ranks differ"
        rows.append(got[0])
    return torch.cat(rows, dim=1)


def _margin_misses(got: torch.Tensor, want: torch.Tensor) -> list:
    """Steps and rows whose greedy token differs where the one process's
    top-1 / top-2 margin exceeds ``MARGIN``."""
    top = want.topk(2, dim=-1).values
    decisive = (top[..., 0] - top[..., 1]) > MARGIN
    diff = got.argmax(-1) != want.argmax(-1)
    return torch.nonzero(decisive & diff).tolist()


# ---------------------------------------------------------------------------
# (a) K1's and K3's statistics modes
# ---------------------------------------------------------------------------


def _reduced_stats(parts: list) -> torch.Tensor:
    """The ranks' ``(min, max)`` rows reduced as ``ModelSplit.minmax``
    reduces them."""
    st = torch.stack(parts)
    return torch.stack([st[..., 0].amin(0), st[..., 1].amax(0)], -1)


K1_CASES = [("dwt", 3, True, 64, 96), ("dwt", 2, False, 8, 40),
            ("wht", 0, True, 64, 72), ("wht", 0, False, 16, 64),
            ("dwt", 3, True, 256, 40), ("dwt", 4, True, 64, 200),
            ("wht", 0, True, 64, 200)]


@pytest.mark.parametrize("ranks", (2, 4))
@pytest.mark.parametrize("transform,levels,skip,num_hi,s", K1_CASES)
def test_k1_statistics_modes_give_the_whole_rows_codes(transform, levels,
                                                       skip, num_hi, s,
                                                       ranks):
    """Each rank's block of a row-parallel input (K = 256 over 2 or 4
    ranks): K1's statistics mode, the ranks' rows reduced, K1 with them —
    codes, scales and zero points the whole rows' for the block's
    columns, exactly; spans over 128 rows through the span link first,
    ``num_hi`` ≥ s puts every row at 8 bits."""
    x = torch.from_numpy(_rng(f"k1/{transform}/{s}").standard_normal(
        (2, s, 256)).astype(np.float32)).to(torch.bfloat16)
    kw = dict(transform=transform, levels=levels, skip_first=skip,
              num_hi=num_hi, hi_bits=8, lo_bits=4)
    from repro_torch.kernels import ops
    qx, sx, zx = ops._quantize(x, **kw)

    def stats(blk):
        blk, skw = blk.contiguous(), kw
        if not SM.tq_fits(s, transform, levels, skip):
            blk = SM.stamp_span_transform(blk, transform=transform,
                                          levels=levels, skip_first=skip)
            skw = dict(kw, transform="none")
        return SM.stamp_transform_quantize(blk, stats_only=True, **skw)

    blocks = x.chunk(ranks, dim=-1)
    whole = _reduced_stats([stats(b) for b in blocks])
    c = 256 // ranks
    for r, blk in enumerate(blocks):
        q, sc, zp = ops._quantize(
            blk, row_minmax=lambda mn, mx: (whole[:, 0], whole[:, 1]), **kw)
        assert torch.equal(q, qx[:, r * c:(r + 1) * c])
        assert torch.equal(sc, sx) and torch.equal(zp, zx)


@pytest.mark.parametrize("ranks", (2, 4))
@pytest.mark.parametrize("transform,levels,skip,num_hi,s", K1_CASES)
def test_k2_parts_summed_over_the_ranks_are_one_devices(transform, levels,
                                                        skip, num_hi, s,
                                                        ranks):
    """The row-parallel fused linear (K1's statistics modes, then K2's
    parts on each rank's block and codes, summed as ``ModelSplit.sum``
    sums them, and K2's summed mode with the bias) against the whole
    rows' K1 -> K2: equal, bit for bit; the summed parts' last row holds
    the whole weight's column sums and K."""
    from repro_torch.core.stamp import prepare_linear
    from repro_torch.kernels import ops
    r = _rng(f"k2/{transform}/{s}")
    x = torch.from_numpy(r.standard_normal((2, s, 256)).astype(
        np.float32)).to(torch.bfloat16)
    p = prepare_linear(torch.from_numpy(r.standard_normal((256, 96)).astype(
        np.float32)) / 16)
    bias = torch.from_numpy(r.standard_normal(96).astype(np.float32))
    kw = dict(transform=transform, levels=levels, skip_first=skip,
              num_hi=num_hi, hi_bits=8, lo_bits=4)
    one = ops.stamp_quant_matmul(x, p.qw, p.sw, p.zw, p.qw_sum, bias, **kw)
    blocks = [b.contiguous() for b in x.chunk(ranks, dim=-1)]
    c = 256 // ranks
    stats = []
    for b in blocks:
        ops._quantize(b, **kw, row_minmax=lambda mn, mx: stats.append(
            (mn, mx)) or (mn, mx))
    whole = (torch.stack([t[0] for t in stats]).amin(0),
             torch.stack([t[1] for t in stats]).amax(0))
    parts = []
    for i, b in enumerate(blocks):
        wq = p.qw[i * c:(i + 1) * c]
        ops.stamp_quant_matmul(
            b, wq, p.sw, p.zw, wq.sum(dim=0, keepdim=True, dtype=torch.int32),
            bias, **kw, row_minmax=lambda mn, mx: whole,
            sum_parts=lambda t: parts.append(t) or t)
    summed = sum(parts)
    assert torch.equal(summed[-1, :-1], p.qw_sum.reshape(-1))
    assert int(summed[-1, -1]) == 256
    qx, sx, zx = ops._quantize(blocks[0], **kw,
                               row_minmax=lambda mn, mx: whole)
    got = SM.stamp_int_gemm_summed(summed, sx, zx, s, p.sw, p.zw, bias,
                                   transform=transform, levels=levels,
                                   skip_first=skip, out_dtype=x.dtype)
    assert torch.equal(got, one)


@pytest.mark.parametrize("ranks", (2, 4))
def test_k3_statistics_modes_give_the_whole_rows_codes(ranks):
    """K3's plain statistics mode on each rank's block of decode rows,
    reduced, then K3's parts mode with them: each block's codes equal the
    whole rows' restricted to its K range, and the ranks' parts summed and
    finished by the summed mode are the whole rows' K3 output, exactly."""
    r = _rng("k3")
    x = torch.from_numpy(r.standard_normal((4, 512)).astype(np.float32))
    w = torch.from_numpy(r.standard_normal((512, 96)).astype(np.float32))
    bias = torch.from_numpy(r.standard_normal(96).astype(np.float32))
    from repro_torch.core.stamp import prepare_linear
    prep = prepare_linear(w)
    whole_q, whole_s, whole_z = DM.row_quantize8(x)
    blocks = x.chunk(ranks, dim=-1)
    stats = _reduced_stats([DM.decode_row_minmax(b) for b in blocks])
    parts = []
    for i, blk in enumerate(blocks):
        q, s, z = DM.row_quantize8(blk, stats)
        c = 512 // ranks
        assert torch.equal(q, whole_q[:, i * c:(i + 1) * c])
        assert torch.equal(s, whole_s) and torch.equal(z, whole_z)
        wq = prep.qw[i * c:(i + 1) * c]
        parts.append(DM.stamp_decode_matmul_parts(
            blk, wq, wq.sum(dim=0, keepdim=True, dtype=torch.int32), stats))
    summed = sum(parts)
    assert torch.equal(summed[-1, :-1], prep.qw_sum.reshape(-1))
    assert int(summed[-1, -1]) == 512
    for od in (torch.float32, torch.bfloat16):
        whole = DM.stamp_decode_matmul(x, prep.qw, prep.sw, prep.zw,
                                       prep.qw_sum, bias, out_dtype=od)
        assert torch.equal(DM.stamp_decode_matmul_summed(
            summed, stats, prep.sw, prep.zw, bias, out_dtype=od), whole)


# ---------------------------------------------------------------------------
# (b) K6's block mode and the cache's blocks
# ---------------------------------------------------------------------------


def _group(rank: int, size: int) -> SH.SeqGroup:
    """Rank ``rank`` of a sequence group over ``size`` model ranks (no
    process group: its regions alone)."""
    return SH.SeqGroup(None, rank, size, rank, size)


def _kv(cap, s, seed, hd=32, g=2):
    r = _rng(f"kv/{seed}")
    k = torch.from_numpy(r.standard_normal((2, s, g, hd)).astype(
        np.float32)).to(torch.bfloat16)
    v = torch.from_numpy(r.standard_normal((2, s, g, hd)).astype(
        np.float32)).to(torch.bfloat16)
    return k, v


# (capacity, prompt, num_hi, lengths): the hi region split; an empty
# block past every length; a hi region of 6 no block count divides
# (whole, read by rank 0 alone); lengths on block edges
K6_CASES = [(96, 72, 64, (73, 90)), (96, 40, 64, (40, 41)),
            (128, 100, 6, (101, 128)), (80, 64, 64, (1, 80))]


@pytest.mark.parametrize("ranks", (2, 4))
@pytest.mark.parametrize("cap,s,num_hi,lengths", K6_CASES)
def test_k6_block_mode_merged_against_the_whole_cache(cap, s, num_hi,
                                                      lengths, ranks):
    """Each rank's block of the cache (``quantize_full`` with its
    ``SeqBlock``) is the whole cache's slices, exactly; K6's plain block
    mode over each block, the states merged in rank order, within 1e-5
    (relative to the largest output) of the whole-cache K6 — f32 sums in
    another order."""
    k, v = _kv(cap, s, f"{cap}/{s}/{num_hi}")
    kvc = KV.KVCacheConfig(num_hi=num_hi)
    whole = KV.quantize_full(k, v, kvc, capacity=cap)
    q = torch.from_numpy(_rng(f"q/{cap}").standard_normal(
        (2, 1, 8, 32)).astype(np.float32))
    length = torch.tensor(lengths, dtype=torch.int32)
    want = CA.cache_decode_attention(whole, q, length)
    states = []
    hi = min(num_hi, cap)
    for r in range(ranks):
        blk = KV.seq_block(kvc, cap, _group(r, ranks))
        mine = KV.quantize_full(k, v, kvc, capacity=cap, block=blk)
        for name in ("k", "v"):
            assert torch.equal(mine[f"{name}_hi"], whole[f"{name}_hi"][
                :, blk.hi0:blk.hi0 + blk.hi_n])
            assert torch.equal(mine[f"{name}_lo"], whole[f"{name}_lo"][
                :, blk.lo0 - hi:blk.lo0 - hi + blk.lo_n])
            for suffix in ("scale", "zp"):
                t = whole[f"{name}_{suffix}"]
                assert torch.equal(mine[f"{name}_{suffix}"], torch.cat([
                    t[:, blk.hi0:blk.hi0 + blk.hi_n],
                    t[:, blk.lo0:blk.lo0 + blk.lo_n]], dim=1))
        states.append(CA.cache_decode_attention(
            mine, q, length, (blk.hi0 if blk.hi_read else CA.NEVER,
                              blk.lo0 if blk.lo_read else CA.NEVER)))
    if num_hi % ranks:
        assert KV.seq_block(kvc, cap, _group(1, ranks)).hi_read is False
    got = CA.merge_states(torch.stack(states), q.dtype)
    assert _rel(got, want) <= 1e-5
    if lengths == (40, 41) and ranks == 4:
        # positions 64 .. 95 lie past every length: those blocks' states
        # carry m = -inf, l = 0
        assert float(states[3][..., 0].max()) == -float("inf")
        assert float(states[3][..., 1].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# (c, d) prefill and decode on the meshes against one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("ex", EXECUTIONS)
@pytest.mark.parametrize("arch", ARCHS)
def test_split_serving_against_one_process(runs, arch, ex, mesh):
    """The prefill's logits within ``PREFILL_TOL`` and the 8 decode
    steps' within ``DECODE_TOL`` of one process's, gathered whole on
    every model rank; the greedy token equal wherever the one process's
    margin exceeds ``MARGIN``."""
    got = _logits(runs, mesh, (mesh, arch, ex))
    want = runs["one"][(arch, ex)]["logits"]
    assert got.shape == want.shape
    assert _rel(got[0], want[0]) <= PREFILL_TOL
    tol = MOE_DECODE_TOL if arch == "arctic-480b" and ex == "reference" \
        else DECODE_TOL[ex]
    assert _rel(got[1:], want[1:]) <= tol
    assert not _margin_misses(got, want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("ex", EXECUTIONS)
@pytest.mark.parametrize("arch", ARCHS)
def test_each_ranks_cache_block(runs, arch, ex, mesh):
    """Each rank holds its block of the cache (``SeqBlock`` over the
    mesh's ``model`` ranks, its data rank's rows), the one process's bit
    for bit, ``xk`` / ``xv`` included: every layer's in the fused
    execution (its row-parallel parts are integer products, summed in f32
    and rounded once), the first layer's in the reference execution
    (whose later layers' K / V carry its bf16 row-parallel products'
    rounding: at most ``REF_CODE_FLIPS`` of their codes differ)."""
    world, mp = MESHES[mesh]
    ranks = runs["ranks"][world]
    one = runs["one"][(arch, ex)]["cache"]
    kvc = _serve(ex).kv
    for rank in range(world):
        d, m = divmod(rank, mp)
        rows = slice(d * B // (world // mp), (d + 1) * B // (world // mp))
        blk = KV.seq_block(kvc, CAP, _group(m, mp))
        hi = min(kvc.num_hi, CAP)
        got = ranks[rank][(mesh, arch, ex)]["cache"]
        for layer, (g, w) in enumerate(zip(got, one)):
            want = {}
            for name in ("k", "v"):
                want[f"{name}_hi"] = w[f"{name}_hi"][
                    rows, blk.hi0:blk.hi0 + blk.hi_n]
                want[f"{name}_lo"] = w[f"{name}_lo"][
                    rows, blk.lo0 - hi:blk.lo0 - hi + blk.lo_n]
                for suffix in ("scale", "zp"):
                    t = w[f"{name}_{suffix}"][rows]
                    want[f"{name}_{suffix}"] = torch.cat([
                        t[:, blk.hi0:blk.hi0 + blk.hi_n],
                        t[:, blk.lo0:blk.lo0 + blk.lo_n]], dim=1)
                if f"x{name}" in w:
                    x0, xn, _ = _group(m, mp).region(w[f"x{name}"].shape[1])
                    want[f"x{name}"] = w[f"x{name}"][rows, x0:x0 + xn]
            assert set(g) == set(want)
            for key in want:
                if ex == "fused" or layer == 0:
                    assert torch.equal(g[key], want[key]), (layer, key)
                else:
                    assert g[key].shape == want[key].shape, (layer, key)
                    assert float((g[key] != want[key]).float().mean()) \
                        <= REF_CODE_FLIPS, (layer, key)


def test_rule_table_placement_equals_the_blocks(runs):
    """Reduced llama3-8b's packed weights placed by the rule table
    (DTensors, each layer's leaves gathered with their ``model`` blocks,
    as the dry run places them) give the blocks route's logits on (1, 4)
    bit for bit."""
    for r in runs["ranks"][4]:
        assert torch.equal(r["placed"]["logits"],
                           r[((1, 4), REF_ARCH, "reference")]["logits"])


def test_quant_telemetry_is_one_devices(runs):
    """Quant telemetry under a (1, 4) split (fused execution, whose split
    prefill is one process's bit for bit): each STaMP site's stats are
    one process's — a row-parallel site's element counts (clipped,
    saturated, elements) summed over the model ranks, its per-row counts
    and scale extremes every rank's alike, column-parallel sites' whole
    rows'."""
    _, cfg = _cfgs(REF_ARCH)
    one = _telemetry(_serve_params(runs["weights"][REF_ARCH], cfg, "fused",
                                   None), cfg, _inputs(cfg))
    for r in runs["ranks"][4]:
        got = r["telemetry"]
        assert set(got) == set(one) and {"qkv", "wo", "gate_up",
                                         "wo_mlp"} <= set(got)
        for site, stats in one.items():
            for key, want in stats.items():
                assert torch.equal(got[site][key], want), (site, key)


# ---------------------------------------------------------------------------
# (e) the reference under a (1, 4) policy
# ---------------------------------------------------------------------------


def test_against_the_reference_model_parallel_serve(runs):
    """The reference's ``prefill`` and 8 ``decode_step`` s under a (1, 4)
    policy on 4 forced host devices (reference execution, every row at 8
    bits, XLA's excess precision off): the port's (1, 4) split logits
    within ``REF_TOL``, the first tokens identical and the rest under the
    margin rule."""
    got = runs["ranks"][4][0]["reference_8bit"]["logits"]
    want = runs["reference"]
    assert got.shape == want.shape
    assert _rel(got, want) <= REF_TOL
    assert torch.equal(got[0].argmax(-1), want[0].argmax(-1))
    assert not _margin_misses(got, want)


# ---------------------------------------------------------------------------
# (f) the dry run against a real rank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ("prefill", "decode"))
def test_dry_run_serve_flops_equal_a_real_rank(runs, kind):
    """The dry run of reduced minicpm-2b's ``SMALL`` serve cell on a fake
    (1, 4) group counts each real gloo rank's ``FlopCounterMode`` total
    exactly, and a quarter of the one-device step's (4 heads over 4
    ranks)."""
    from repro_torch.analysis import opstats as OS
    from repro_torch.launch import dryrun as DR
    cfg = get_reduced("minicpm-2b")
    rec = DR.lower_cell("minicpm-2b", None, multi_pod=False, cfg=cfg,
                        shape=SMALL[kind], mesh_shape=(1, 4), device="cpu")
    assert rec["model_split"]["split"]
    got = OS.op_stats(rec["counter"].log())["dot_flops_per_device"]
    assert all(r["flops"][kind] == got for r in runs["ranks"][4])
    one = DR.lower_cell("minicpm-2b", None, multi_pod=False, cfg=cfg,
                        shape=SMALL[kind], sharded=False, device="cpu")
    assert OS.op_stats(one["counter"].log())["dot_flops_per_device"] == \
        4 * got


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(Path(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))

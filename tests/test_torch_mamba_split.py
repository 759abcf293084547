"""The model axis's split of the Mamba mixers (``lm.train_loss`` under a
``ModelSplit``, ``lm.prefill`` / ``lm.decode_step`` under a policy, the
dry run) on the CPU, held against one process and against the reference.

* The part-aware cut (``lm.model_blocks`` / ``prepare_fused_weights(...,
  split=)``) of every mixer leaf, plain, packed and prepared: ``in_proj``
  as ``[z block | x block | B | C | dt block | pad]``, ``conv_w`` as
  ``[x block | B | C]``, the heads' ``a_log`` / ``dt_bias`` / ``d_skip``,
  ``ssm_norm``'s and ``out_proj``'s d_inner block, against slices of the
  whole leaf, exactly; 16 heads on 8 ranks pad the dt block (98 columns
  to 100) and the in-projection through the plain K1 -> K2 and K3 gives
  the whole projection's columns, and the conv and SSD over a rank's
  heads the whole scan's state and output blocks, bit for bit; K3's
  plain parts mode over each rank's block of decode rows, the parts
  summed and finished by its summed mode, the whole rows' K3 output bit
  for bit (the split decode's row-parallel ``out_proj``).
* Reduced mamba2-1.3b and Jamba (16 SSM heads; Jamba with its attention
  and MoE layers) on (1, 4), (2, 2) and (1, 2) meshes of gloo workers
  against one process, weights converted from the reference's
  ``init_params``:
  - the training loss and grad norm within bounds set from the measured
    gaps, in bf16 compute and in f32 compute on both sides, and in f32
    each rank's gradient block of every leaf within its bound (a
    replicated leaf's gradient is summed over the model ranks once);
  - prefill and 8 teacher-forced decode steps in both STaMP executions:
    logits within bounds set from the measured gaps, greedy tokens equal
    wherever the one process's top-1 / top-2 margin exceeds 0.1, and the
    first layer's SSM state and conv cache each rank's heads' and
    channels' slice of the one process's, bit for bit.  The gated norm's
    per-head f32 sums of squares are gathered over the model ranks and
    summed as one process sums them, so its statistic is one process's
    bit for bit.
* The reference's ``prefill`` / ``decode_step`` for reduced mamba2 under
  a (1, 4) policy on 4 forced host devices (reference execution, every
  row at 8 bits, XLA's excess precision off) against the port's (1, 4)
  split.
* The dry run's fake (1, 4) train, prefill and decode dot FLOPs equal
  each real gloo rank's ``FlopCounterMode`` count for reduced mamba2,
  exactly.

The workers are this file run as a script (a ``FileStore`` under the
module's temporary directory), one PyTorch thread each.
"""

import contextlib
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
from repro_torch import tree as TR
from repro_torch.configs import get_reduced
from repro_torch.core.stamp import StampConfig
from repro_torch.models import lm as TLM
from repro_torch.models.config import ShapeConfig
from repro_torch.serving import kvcache as KV

ROOT = Path(__file__).resolve().parents[1]

B, S, CAP, STEPS = 2, 72, 96, 8          # serving
TB, TS = 2, 64                           # training
ARCHS = ("mamba2-1.3b", "jamba-1.5-large-398b")
EXECUTIONS = ("reference", "fused")
# (world, model ranks): the (1, 4) and (2, 2) meshes share one group of
# four, the (1, 2) mesh is a group of two
MESHES = {(1, 4): (4, 4), (2, 2): (4, 2), (1, 2): (2, 2)}
REF_ARCH = "mamba2-1.3b"                 # the reference's (1, 4) run
SMALL = {"train": ShapeConfig("train_small", TS, TB, "train"),
         "prefill": ShapeConfig("prefill_small", S, B, "prefill"),
         "decode": ShapeConfig("decode_small", CAP, B, "decode")}
# the training step in bf16 compute, and in f32 compute on both sides
# (the witness that the bf16 gaps are rounding)
TRAIN_DTYPES = {"train": torch.bfloat16, "train_f32": torch.float32}
MARGIN = 0.1
# bounds (max |split − one| / max |one|, or the relative gap of a loss or
# grad norm), each above its measured gap (every mesh, both archs):
# serving, the prefill's logits 0 and the decode steps' 0 (mamba2) and
# 0.0101 (Jamba's reference execution: its attention's partial softmax
# states merged over the ranks in another order); training in bf16, the
# loss 7.0e-4 and the grad norm 1.3e-3; in f32 compute, the loss 1.4e-7,
# the grad norm 1.1e-7 and every leaf's gradient block 6.0e-6; against
# the reference's (1, 4) serve 0.0222
PREFILL_TOL = 1e-2
DECODE_TOL = 3e-2
LOSS_REL, GNORM_REL = 2e-3, 4e-3
F32_LOSS_REL, F32_GNORM_REL, F32_GRAD_TOL = 1e-6, 1e-6, 2e-5
REF_TOL = 0.05


def _rng(tag: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(tag.encode()))


def _cfgs(arch: str) -> tuple:
    from repro.configs import get_reduced as jget
    return jget(arch), get_reduced(arch)


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
    tok = r.integers(0, cfg.vocab_size, (TB, TS + 1)).astype(np.int32)
    return {"tokens": r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "forced": r.integers(0, cfg.vocab_size,
                                 (STEPS, B)).astype(np.int32),
            "train": {"tokens": tok[:, :-1], "labels": tok[:, 1:].copy()}}


def _packed(params: dict) -> dict:
    """The layers' large weights packed to int4, whole."""
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
    logits and the first layer's cache entry after the prefill."""
    with torch.no_grad():
        logits, cache = TLM.prefill(params, torch.from_numpy(
            inp["tokens"][rows]), cfg, serve, policy=policy)
        first = {k: v.clone() for k, v in cache[0].items()}
        out = [logits]
        for i in range(STEPS):
            tok = torch.from_numpy(inp["forced"][i][rows])
            logits, cache = TLM.decode_step(params, cache, tok, S + i, cfg,
                                            serve, policy=policy)
            out.append(logits)
    return {"logits": torch.stack(out), "first": first}


@contextlib.contextmanager
def _compute(dtype):
    """The port's forward in ``dtype`` (``lm.COMPUTE_DTYPE``) inside."""
    old, TLM.COMPUTE_DTYPE = TLM.COMPUTE_DTYPE, dtype
    try:
        yield
    finally:
        TLM.COMPUTE_DTYPE = old


def _train(params, cfg, inp, policy=None, rows=slice(None),
           dtype=torch.bfloat16) -> dict:
    """The training loss of ``inp``'s batch (this rank's rows) in
    ``dtype`` compute, every leaf's gradient (this rank's block) and the
    global grad norm."""
    batch = {k: torch.from_numpy(v[rows]) for k, v in inp["train"].items()}
    params = TR.tree_map(lambda t: t.detach().clone(), params)
    if policy is not None:
        params = policy.place(params)
    flat = TR.flatten_with_paths(params)
    leaves = [t for _, t in flat]
    for t in leaves:
        t.requires_grad_(True)
    with _compute(dtype):
        loss = TLM.train_loss(params, batch, cfg, policy)
        grads = torch.autograd.grad(loss, leaves)
    sq = SH.sum_over_shards([SH.local(g).float().square().sum()
                             for g in grads], leaves)
    return {"loss": float(loss.detach()), "gnorm": float(sum(sq)) ** 0.5,
            "grads": {TR.path_name(p): SH.local(g).detach().clone()
                      for (p, _), g in zip(flat, grads)}}


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
            trows = slice(data * TB // n_data, (data + 1) * TB // n_data)
            for arch in ARCHS:
                _, cfg = _cfgs(arch)
                inp = _inputs(cfg)
                for name, dtype in TRAIN_DTYPES.items():
                    out[(mesh, arch, name)] = _train(weights[arch], cfg, inp,
                                                     policy, trows, dtype)
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
                # the rule table's placement (the mixers' leaves gathered
                # whole along model and cut by part) gives the blocks
                # route's numbers
                placed = policy.place(_packed(weights[REF_ARCH]))
                out["placed"] = _run(placed, cfg, _serve("reference"),
                                     _inputs(cfg), policy)
                out["flops"] = {}
                for kind in SMALL:
                    with FlopCounterMode(display=False) as fc:
                        _flop_step(kind, policy)
                    out["flops"][kind] = fc.get_total_flops()
        torch.save(out, work / f"out{world}_{rank}.pt")
    finally:
        dist.destroy_process_group()


def _flop_step(kind: str, policy) -> None:
    """The dry run's cell on real tensors for reduced mamba2: the train
    step of its f32 parameters placed by the rule table, or
    ``make_serve_config``'s prefill of ``SMALL["prefill"]`` / one decode
    step over a cache of ``SMALL["decode"]`` on its packed bf16
    parameters placed by the rule table."""
    from repro_torch.launch import specs as LS
    from repro_torch.launch.train import build_step
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = get_reduced(REF_ARCH)
    shape = SMALL[kind]
    idx, n = policy._batch_index()
    b = shape.global_batch // n
    if kind == "train":
        params = policy.place(TLM.init_params(cfg, 0, device="cpu"))
        for leaf in TR.leaves(params):
            leaf.requires_grad_(True)
        opt = adamw_init(params, AdamWConfig())
        tok = torch.zeros((b, shape.seq_len), dtype=torch.int32)
        step = build_step(cfg, policy, AdamWConfig(), False)
        step(params, opt, {"_": torch.zeros(())},
             {"tokens": tok, "labels": tok})
        return
    serve = dataclasses.replace(LS.make_serve_config(cfg),
                                cache_capacity=shape.seq_len)
    params = policy.place(_packed(TLM.init_params(cfg, 0, device="cpu",
                                                  dtype=torch.bfloat16)))
    with torch.no_grad():
        if kind == "prefill":
            tok = torch.zeros((b, shape.seq_len), dtype=torch.int32)
            TLM.prefill(params, tok, cfg, serve, policy=policy,
                        global_batch=shape.global_batch)
        else:
            cache = TLM.init_cache(cfg, b, shape.seq_len, serve, "cpu",
                                   group=policy.seq_group(shape.global_batch),
                                   split=policy.model_split())
            TLM.decode_step(params, cache, torch.zeros(b, dtype=torch.int32),
                            shape.seq_len - 1, cfg, serve, policy=policy,
                            global_batch=shape.global_batch)


REFERENCE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
sys.path.insert(0, {tests!r})
import test_torch_mamba_split as T
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
params = jax.device_put(params, policy.params_shardings(params))
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
    work = tmp_path_factory.mktemp("mamba_split")
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
        weights[arch] = TLM.from_jax_params(tree, tc)
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
            inp = _inputs(cfg)
            for name, dtype in TRAIN_DTYPES.items():
                one[(arch, name)] = _train(weights[arch], cfg, inp,
                                           dtype=dtype)
            for ex in EXECUTIONS:
                one[(arch, ex)] = _run(_serve_params(weights[arch], cfg, ex,
                                                     None), cfg, _serve(ex),
                                       inp)
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


def _heads(cfg, m: int, mp: int) -> tuple:
    """Model rank ``m``'s heads and its x channels' ``[start, stop)``."""
    h = cfg.ssm_heads // mp
    return (m * h, (m + 1) * h), (m * h * cfg.ssm_head_dim,
                                  (m + 1) * h * cfg.ssm_head_dim)


# ---------------------------------------------------------------------------
# (a) the cut, and a padded dt block
# ---------------------------------------------------------------------------


def _whole_layer(arch: str) -> tuple:
    cfg = get_reduced(arch)
    params = TLM.init_params(cfg, 0, device="cpu")
    return cfg, params["layers"][0]


def _xbc_block(t, cfg, x0, x1):
    di = cfg.d_inner
    return torch.cat([t[..., x0:x1], t[..., di:]], dim=-1)


@pytest.mark.parametrize("ranks", (2, 4, 8))
@pytest.mark.parametrize("form", ("plain", "packed", "prepared"))
def test_mixer_leaves_cut_by_part(form, ranks):
    """Each rank's mixer leaves, from the whole leaf (packed and prepared
    whole first), against slices of the whole leaf, exactly: ``in_proj``
    ``[z | x | B | C | dt | pad]`` (every leaf of a packed / prepared
    dict; zeros in the pad), ``conv_w`` ``[x | B | C]``, the heads'
    vectors, ``ssm_norm``'s and ``out_proj``'s d_inner rows (a prepared
    ``out_proj`` block keeps the whole columns' ``isw`` / ``izw`` and takes
    its rows' ``iqsum``)."""
    cfg, layer = _whole_layer("mamba2-1.3b")
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    stamp = _stamp("fused")
    whole = {"plain": layer, "packed": TLM.quantize_weights_for_serving(
        layer, 4)}
    whole["prepared"] = TLM.prepare_fused_weights(
        {"layers": [whole["packed"]]}, stamp)["layers"][0]
    w = whole[form]
    for r in range(ranks):
        split = SH.ModelSplit(None, r, ranks)
        if form == "prepared":
            got = TLM.prepare_fused_weights({"layers": [whole["packed"]]},
                                            stamp, split)["layers"][0]
        else:
            got = TLM.model_blocks({"layers": [w]}, split)["layers"][0]
        (h0, h1), (x0, x1) = _heads(cfg, r, ranks)
        widths = TLM.mixer_widths(cfg, split)
        pad = widths[3]
        assert widths[:3] == [x1 - x0, x1 - x0 + 2 * n, h1 - h0]
        assert (2 * (x1 - x0) + 2 * n + h1 - h0 + pad) % 4 == 0
        assert pad == (2 if ranks == 8 else 0)

        def cols(t):
            return torch.cat([t[..., x0:x1], t[..., di + x0:di + x1],
                              t[..., 2 * di:2 * di + 2 * n],
                              t[..., 2 * di + 2 * n + h0:
                                2 * di + 2 * n + h1]], dim=-1)
        ip = w["in_proj"]
        leaves = ip.items() if isinstance(ip, dict) else [("", ip)]
        for k, t in leaves:
            g = got["in_proj"][k] if k else got["in_proj"]
            assert torch.equal(g[..., :g.shape[-1] - pad], cols(t)), k
            assert not g[..., g.shape[-1] - pad:].any(), k
        assert torch.equal(got["conv_w"], _xbc_block(w["conv_w"], cfg, x0,
                                                     x1))
        for k in ("a_log", "dt_bias", "d_skip"):
            assert torch.equal(got[k], w[k][h0:h1]), k
        assert torch.equal(got["ssm_norm"], w["ssm_norm"][x0:x1])
        op = w["out_proj"]
        if form == "plain":
            assert torch.equal(got["out_proj"], op[x0:x1])
        elif form == "packed":
            assert torch.equal(got["out_proj"]["q"], op["q"][x0 // 2:x1 // 2])
            for k in ("scale", "zp"):
                assert torch.equal(got["out_proj"][k], op[k])
        else:
            iq = op["iq"][x0:x1]
            assert torch.equal(got["out_proj"]["iq"], iq)
            for k in ("isw", "izw"):
                assert torch.equal(got["out_proj"][k], op[k])
            assert torch.equal(got["out_proj"]["iqsum"], iq.sum(
                dim=0, keepdim=True, dtype=torch.int32))


@pytest.mark.parametrize("ranks", (2, 4, 8))
@pytest.mark.parametrize("execution", EXECUTIONS)
def test_rank_in_projection_and_scan_are_the_whole_ones_blocks(execution,
                                                               ranks):
    """A rank's in-projection (column-parallel on the whole rows: the
    plain K1 -> K2 in the fused execution, STaMP's round trip and the
    dequantized product in the reference one; at 8 ranks the dt block
    padded from 98 columns to 100), and its conv and SSD over its
    channels and heads — prefill rows, then one decode row through the
    plain K3 — give the whole layer's z / x / B / C / dt columns, output
    heads, state and conv tail blocks, bit for bit."""
    cfg, layer = _whole_layer("mamba2-1.3b")
    stamp = _stamp(execution)
    packed = TLM.quantize_weights_for_serving(layer, 4)
    whole = TLM.prepare_fused_weights({"layers": [packed]},
                                      _stamp("fused"))["layers"][0] \
        if execution == "fused" else packed
    r = _rng(f"scan/{execution}")
    x = torch.from_numpy(r.standard_normal((2, 64, cfg.d_model)).astype(
        np.float32)).to(torch.bfloat16)
    xd = torch.from_numpy(r.standard_normal((2, 1, cfg.d_model)).astype(
        np.float32)).to(torch.bfloat16)
    dm = execution == "fused"

    def layer_run(p, split):
        z, xbc, dt = TLM._mamba_in(p, x, cfg, stamp, False, split)
        yh, state, conv = TLM._mamba_scan(p, xbc, dt, cfg, None, None, None,
                                          x.dtype)
        zd, xbcd, dtd = TLM._mamba_in(p, xd, cfg, None, dm, split)
        yd, state_d, conv_d = TLM._mamba_step(p, xbcd, dtd, state, conv, cfg,
                                              x.dtype)
        return dict(z=z, xbc=xbc, dt=dt, yh=yh, state=state, conv=conv,
                    zd=zd, xbcd=xbcd, dtd=dtd, yd=yd, state_d=state_d,
                    conv_d=conv_d)

    one = layer_run(whole, None)
    for rank in range(ranks):
        split = SH.ModelSplit(None, rank, ranks)
        blk = TLM.prepare_fused_weights({"layers": [packed]}, stamp,
                                        split)["layers"][0] \
            if execution == "fused" else \
            TLM.model_blocks({"layers": [packed]}, split)["layers"][0]
        if ranks == 8 and execution == "fused":
            assert blk["in_proj"]["iq"].shape[-1] == 100
        got = layer_run(blk, split)
        (h0, h1), (x0, x1) = _heads(cfg, rank, ranks)
        for sfx in ("", "d"):
            assert torch.equal(got["z" + sfx], one["z" + sfx][..., x0:x1])
            assert torch.equal(got["dt" + sfx], one["dt" + sfx][..., h0:h1])
            assert torch.equal(got["xbc" + sfx],
                               _xbc_block(one["xbc" + sfx], cfg, x0, x1))
        for k in ("yh", "yd"):
            assert torch.equal(got[k], one[k][:, :, h0:h1]), k
        for k in ("state", "state_d"):
            assert torch.equal(got[k], one[k][:, h0:h1]), k
        for k in ("conv", "conv_d"):
            assert torch.equal(got[k], _xbc_block(one[k], cfg, x0, x1)), k


@pytest.mark.parametrize("rows", (1, 4, 9))
@pytest.mark.parametrize("ranks", (2, 4))
def test_k3_parts_summed_over_the_ranks_are_one_devices(ranks, rows):
    """K3's plain parts mode on each rank's block of decode rows (K 512
    over 2 or 4 ranks, quantized with the whole rows' reduced statistics),
    the parts summed as ``ModelSplit.sum`` sums them and finished by its
    summed mode: the whole rows' K3 output bit for bit, in f32 and bf16,
    with and without a bias; the summed parts' last row holds the whole
    weight's column sums and K."""
    from repro_torch.core.stamp import prepare_linear
    from repro_torch.kernels import decode_matmul as DM
    r = _rng(f"k3parts/{ranks}/{rows}")
    x = torch.from_numpy(r.standard_normal((rows, 512)).astype(
        np.float32)).to(torch.bfloat16)
    p = prepare_linear(torch.from_numpy(r.standard_normal((512, 96)).astype(
        np.float32)) / 16)
    bias = torch.from_numpy(r.standard_normal(96).astype(np.float32))
    c = 512 // ranks
    blocks = x.chunk(ranks, dim=-1)
    st = torch.stack([DM.decode_row_minmax(b) for b in blocks])
    stats = torch.stack([st[..., 0].amin(0), st[..., 1].amax(0)], -1)
    parts = []
    for i, b in enumerate(blocks):
        wq = p.qw[i * c:(i + 1) * c]
        parts.append(DM.stamp_decode_matmul_parts(
            b, wq, wq.sum(dim=0, keepdim=True, dtype=torch.int32), stats))
    summed = sum(parts)
    assert torch.equal(summed[-1, :-1], p.qw_sum.reshape(-1))
    assert int(summed[-1, -1]) == 512
    for out_dtype in (torch.float32, torch.bfloat16):
        for b in (None, bias):
            want = DM.stamp_decode_matmul(x, p.qw, p.sw, p.zw, p.qw_sum, b,
                                          out_dtype=out_dtype)
            got = DM.stamp_decode_matmul_summed(summed, stats, p.sw, p.zw, b,
                                                out_dtype=out_dtype)
            assert torch.equal(got, want)


def test_heads_the_axis_does_not_divide_are_refused():
    """16 heads on 3 (or 32) model ranks: refused, as the split refuses a
    dim the axis does not divide."""
    cfg, layer = _whole_layer("mamba2-1.3b")
    for ranks in (3, 32):
        split = SH.ModelSplit(None, 0, ranks)
        with pytest.raises(ValueError, match="does not split"):
            TLM.model_blocks({"layers": [layer]}, split)
        with pytest.raises(ValueError, match="does not split"):
            TLM.mixer_widths(cfg, split)


# ---------------------------------------------------------------------------
# (b) training on the meshes against one process
# ---------------------------------------------------------------------------


def _block_of(full: torch.Tensor, spec, coord: dict, sizes: dict):
    """Rank ``coord``'s block of ``full`` under ``spec`` (over the mesh
    axes ``sizes``)."""
    out = full
    for d, entry in enumerate(spec):
        axes = SH._axes(entry)
        if not axes:
            continue
        idx, n = 0, 1
        for a in axes:
            idx, n = idx * sizes[a] + coord[a], n * sizes[a]
        c = full.shape[d] // n
        out = out.narrow(d, idx * c, c)
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_split_training_against_one_process(runs, arch, mesh):
    """In bf16 compute the training loss within ``LOSS_REL`` and the grad
    norm within ``GNORM_REL`` of one process's (the split sums its
    row-parallel bf16 parts, each rounded, and the gated norm's
    statistic in another order; a leaf's own gradient then moves by more:
    measured at most 0.23 of its largest element for ``dt_bias``, whose
    gradient is a sum of cancelling terms, and 0.58 for Jamba's experts,
    whose routing a rounding can flip), every model rank's loss alike.
    In f32 compute on both sides (the witness that those gaps are
    rounding) the loss within ``F32_LOSS_REL``, the grad norm within
    ``F32_GNORM_REL`` and each rank's block of every leaf's gradient
    within ``F32_GRAD_TOL`` of the one process's block (a replicated
    leaf's summed over the model ranks once)."""
    world, mp = MESHES[mesh]
    ranks = runs["ranks"][world]
    policy = SH.ShardingPolicy(mesh=None)
    sizes = {"data": world // mp, "model": mp}
    template = runs["weights"][arch]
    for key, loss_rel, gnorm_rel in (("train", LOSS_REL, GNORM_REL),
                                     ("train_f32", F32_LOSS_REL,
                                      F32_GNORM_REL)):
        one = runs["one"][(arch, key)]
        for rank, r in enumerate(ranks):
            got = r[(mesh, arch, key)]
            assert abs(got["loss"] - one["loss"]) <= \
                loss_rel * abs(one["loss"]), (key, got["loss"])
            assert abs(got["gnorm"] - one["gnorm"]) <= \
                gnorm_rel * one["gnorm"], (key, got["gnorm"])
            if key == "train":
                continue
            coord = dict(zip(("data", "model"), divmod(rank, mp)))
            for path, leaf in TR.flatten_with_paths(template):
                name = TR.path_name(path)
                want = _block_of(one["grads"][name],
                                 policy.param_spec(name, leaf.dim()), coord,
                                 sizes)
                assert got["grads"][name].shape == want.shape, name
                assert _rel(got["grads"][name], want) <= F32_GRAD_TOL, name
        losses = [r[(mesh, arch, key)]["loss"] for r in ranks]
        assert all(v == losses[0] for v in losses[:mp])


# ---------------------------------------------------------------------------
# (c) serving on the meshes against one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("ex", EXECUTIONS)
@pytest.mark.parametrize("arch", ARCHS)
def test_split_serving_against_one_process(runs, arch, ex, mesh):
    """The prefill's logits within ``PREFILL_TOL`` and the 8 decode
    steps' within ``DECODE_TOL`` of one process's (measured: the prefill
    0 and mamba2's decode 0 — the gated norm's per-head sums, gathered
    and summed in one process's order, are its statistic; Jamba's decode
    0.0101 in the reference execution, its attention's merge), gathered
    whole on every model rank; the greedy token equal wherever the one
    process's margin exceeds ``MARGIN``."""
    got = _logits(runs, mesh, (mesh, arch, ex))
    want = runs["one"][(arch, ex)]["logits"]
    assert got.shape == want.shape
    assert _rel(got[0], want[0]) <= PREFILL_TOL
    assert _rel(got[1:], want[1:]) <= DECODE_TOL
    assert not _margin_misses(got, want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("ex", EXECUTIONS)
@pytest.mark.parametrize("arch", ARCHS)
def test_each_ranks_first_layer_state_block(runs, arch, ex, mesh):
    """After the prefill each rank holds its heads' SSM state and its
    channels' conv tail ``[x block | B | C]`` of the first layer (its
    data rank's rows): the one process's slices, bit for bit (the
    in-projection's columns and the scan over the rank's heads are the
    whole ones' blocks)."""
    world, mp = MESHES[mesh]
    _, cfg = _cfgs(arch)
    one = runs["one"][(arch, ex)]["first"]
    for rank, r in enumerate(runs["ranks"][world]):
        d, m = divmod(rank, mp)
        rows = slice(d * B // (world // mp), (d + 1) * B // (world // mp))
        (h0, h1), (x0, x1) = _heads(cfg, m, mp)
        got = r[(mesh, arch, ex)]["first"]
        assert torch.equal(got["state"], one["state"][rows, h0:h1])
        assert torch.equal(got["conv"], _xbc_block(one["conv"][rows], cfg,
                                                   x0, x1))


def test_rule_table_placement_equals_the_blocks(runs):
    """Reduced mamba2's packed weights placed by the rule table (DTensors;
    each mixer's leaves gathered whole along ``model`` and cut by part,
    as the dry run places them) give the blocks route's logits on (1, 4)
    bit for bit."""
    for r in runs["ranks"][4]:
        assert torch.equal(r["placed"]["logits"],
                           r[((1, 4), REF_ARCH, "reference")]["logits"])


# ---------------------------------------------------------------------------
# (d) the reference under a (1, 4) policy
# ---------------------------------------------------------------------------


def test_against_the_reference_model_parallel_serve(runs):
    """The reference's ``prefill`` and 8 ``decode_step`` s of reduced
    mamba2 under a (1, 4) policy on 4 forced host devices (reference
    execution, every row at 8 bits, XLA's excess precision off): the
    port's (1, 4) split logits within ``REF_TOL`` (measured 0.0222), the
    first tokens identical and the rest under the margin rule."""
    got = runs["ranks"][4][0]["reference_8bit"]["logits"]
    want = runs["reference"]
    assert got.shape == want.shape
    assert _rel(got, want) <= REF_TOL
    assert torch.equal(got[0].argmax(-1), want[0].argmax(-1))
    assert not _margin_misses(got, want)


# ---------------------------------------------------------------------------
# (e) the dry run against a real rank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(SMALL))
def test_dry_run_flops_equal_a_real_rank(runs, kind):
    """The dry run of reduced mamba2's ``SMALL`` cell on a fake (1, 4)
    group counts each real gloo rank's ``FlopCounterMode`` total exactly,
    and that is below a third of the one-device cell's (each rank its
    quarter of the mixers' products; B and C's columns and C·Bᵀ stay
    whole)."""
    from repro_torch.analysis import opstats as OS
    from repro_torch.launch import dryrun as DR
    cfg = get_reduced(REF_ARCH)
    rec = DR.lower_cell(REF_ARCH, None, multi_pod=False, cfg=cfg,
                        shape=SMALL[kind], mesh_shape=(1, 4), device="cpu")
    assert rec["model_split"]["split"] and not rec["model_split"]["whole"]
    got = OS.op_stats(rec["counter"].log())["dot_flops_per_device"]
    assert all(r["flops"][kind] == got for r in runs["ranks"][4])
    one = DR.lower_cell(REF_ARCH, None, multi_pod=False, cfg=cfg,
                        shape=SMALL[kind], sharded=False, device="cpu")
    assert 3 * got < OS.op_stats(one["counter"].log())[
        "dot_flops_per_device"]


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(Path(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))

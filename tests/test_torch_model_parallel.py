"""The model axis's split of the training step (``repro_torch.sharding.
ModelSplit`` and the split paths of ``repro_torch.models.lm`` /
``layers``) on the CPU, in one gloo group of four worker processes.

* Each operator on a model axis of 4 ranks (the world group) and of 2
  (two groups of two), held against its one-process function on the same
  inputs (made from a seed with numpy), its gradients through the split's
  copy-in / reduce-out / gather included:
  - the column-parallel linear (a block of the output columns) and the
    row-parallel one (the partial products summed by reduce-out);
  - attention over each rank's heads at head counts that do not divide
    the axis: 6 heads on 4 ranks (1.5 heads a rank), 6 query heads over
    2 KV heads, reduced Arctic's 2 KV heads on 4 ranks;
  - the vocab-parallel embedding and the vocab-parallel chunked loss
    (the loss also against the reference's ``chunked_xent`` under
    ``jax.jit``, value and gradients);
  - the expert-parallel ``moe_ffn`` (every row routed on every rank, each
    rank's experts, the router's gradient summed by a copy-in).
  Tolerances are relative to the largest magnitude of the one-process
  tensor and set from the measured gaps: a column-parallel output is the
  one-process product's columns bit for bit; a reduce-out sums its
  ranks' bf16 partials, each rounded, where one process rounds the whole
  product once.
* A dim the axis does not divide, and STaMP or a cache under a split,
  are refused.
* A leaf replicated along ``model`` (norms, the MoE router, the Mamba
  mixer's per-head leaves, each rank computing its heads' part of their
  gradient, summed over the model ranks by a copy-in) gets the same
  gradient on every model rank: reduced Jamba's ``train_loss`` on a
  (1, 4) mesh.
* The dry run's dot FLOPs on a fake (1, 4) group equal
  ``FlopCounterMode``'s on a real gloo (1, 4) rank for reduced
  minicpm-2b's train step, exactly, and a quarter of the one-device
  step's; against the reference's train step compiled on 4 forced host
  devices with ``model`` 4, the port's count is the reference's plus the
  loss's recomputed head product (the reference's compiled program
  computes a one-chunk scan's logits once) less one attention product a
  layer (the reference's backward takes the key gradient as an extra
  transposed product).
"""

import dataclasses
import json
import os
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

jax.config.update("jax_platform_name", "cpu")

from repro.models import lm as JLM

from repro_torch import sharding as SH
from repro_torch import tree as TR
from repro_torch.analysis import opstats as OS
from repro_torch.configs import get_reduced
from repro_torch.core.stamp import StampConfig
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.train import build_step
from repro_torch.models import layers as L
from repro_torch.models import lm as TLM
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.serving.kvcache import KVCacheConfig

# One PyTorch thread a process (see test_torch_train.py).
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
SIZES = (4, 2)                 # model ranks: the world, or two groups of 2
B, S, CHUNK = 2, 32, 16
TRAIN = ShapeConfig("train_small", 64, 2, "train")
ATTN_CFGS = {
    "heads6_mha": dataclasses.replace(get_reduced("minicpm-2b"),
                                      num_heads=6, num_kv_heads=6,
                                      head_dim=32),
    "heads6_gqa": dataclasses.replace(get_reduced("minicpm-2b"),
                                      num_heads=6, num_kv_heads=2,
                                      head_dim=32),
    "arctic": get_reduced("arctic-480b"),
}
MOE_CFG = get_reduced("arctic-480b")
ROUTER_SCALE = 30.0
# measured (max |split − one| / max |one|): every product's own block
# (column outputs, attention outputs, weight and table blocks' gradients,
# the embedding) 0; row-parallel sums 3.9e-3, the MoE's 2.5e-3; gradients
# summed over the ranks (copy-in, the gathers' reduce-scatter) 9.3e-3 at
# most (6 query heads over 2 KV heads on 4 ranks: dk); the loss 0 against
# one process and against the reference, the router's gradient 8.9e-8
EXACT = 0.0
BF16_STEP = 2.0 ** -8
ROW_TOL = 2 * BF16_STEP          # partials rounded, then summed
GRAD_TOL = 4 * BF16_STEP         # up to 4 ranks' rounded parts summed
LOSS_TOL = 1e-6                  # f32 sums in another order


def _rng(tag: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(tag.encode()))


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def _inputs() -> dict:
    """Every operator's inputs, from numpy seeds: the same in each
    process."""
    d, n = 128, 320
    r = _rng("linear")
    out = {"x": r.standard_normal((B, S, d)),
           "w_col": r.standard_normal((d, n)) / np.sqrt(d),
           "h": r.standard_normal((B, S, n)),
           "w_row": r.standard_normal((n, d)) / np.sqrt(n),
           "t_col": r.standard_normal((B, S, n)),
           "t_row": r.standard_normal((B, S, d))}
    for name, cfg in ATTN_CFGS.items():
        r = _rng(name)
        out[name] = {k: r.standard_normal((B, S, dim)) for k, dim in
                     (("q", cfg.q_dim), ("k", cfg.kv_dim),
                      ("v", cfg.kv_dim), ("t", cfg.q_dim))}
    r = _rng("vocab")
    v = 512
    out["table"] = r.standard_normal((v, d)) * 0.02
    out["tokens"] = r.integers(0, 500, (B, S)).astype(np.int32)
    out["t_embed"] = r.standard_normal((B, S, d))
    out["head"] = r.standard_normal((d, v)) / np.sqrt(d)
    labels = r.integers(0, 500, (B, S)).astype(np.int32)
    labels[0, :5] = -1
    out["labels"] = labels
    r = _rng("moe")
    c = MOE_CFG
    e, f = c.num_experts, c.expert_d_ff
    out["moe"] = {"x": r.standard_normal((B, S, c.d_model)),
                  "gate_w": r.standard_normal((c.d_model, e))
                  * ROUTER_SCALE / np.sqrt(c.d_model),
                  "we_gate": r.standard_normal((e, c.d_model, f))
                  / np.sqrt(c.d_model),
                  "we_up": r.standard_normal((e, c.d_model, f))
                  / np.sqrt(c.d_model),
                  "we_down": r.standard_normal((e, f, c.d_model))
                  / np.sqrt(f),
                  "t": r.standard_normal((B, S, c.d_model))}
    return out


def _leaf(a, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(
        dtype).requires_grad_(True)


def _grads(loss, leaves: list) -> list:
    return [g.detach().clone() for g in torch.autograd.grad(loss, leaves)]


def _cols(a, split, dim=-1):
    """``a``'s block along ``dim`` under ``split`` (whole without): a
    tensor's, or a numpy array's (made a leaf by :func:`_leaf`, so its
    gradient is the block's)."""
    if split is None:
        return a
    i0, i1 = split.block(a.shape[dim])
    if isinstance(a, np.ndarray):
        return np.take(a, np.arange(i0, i1), axis=dim)
    return a.narrow(dim % a.dim(), i0, i1 - i0)


# ---------------------------------------------------------------------------
# the operators, run whole (split None) or on this rank's blocks
# ---------------------------------------------------------------------------


def op_linears(inp: dict, split) -> dict:
    x = _leaf(inp["x"], torch.bfloat16)
    w_col = _leaf(_cols(inp["w_col"], split))
    xin = x if split is None else split.copy_in(x)
    y_col = TLM._linear(xin, w_col)
    t_col = _cols(_bf16(inp["t_col"]).float(), split)
    g_col = _grads((y_col.float() * t_col).sum(), [x, w_col])
    h = _leaf(_cols(inp["h"], split), torch.bfloat16)
    w_row = _leaf(_cols(inp["w_row"], split, 0))
    y_row = TLM._linear(h, w_row)
    y_row = y_row if split is None else split.reduce_out(y_row)
    g_row = _grads((y_row.float() * _bf16(inp["t_row"]).float()).sum(),
                   [h, w_row])
    return {"y_col": y_col.detach(), "dx_col": g_col[0],
            "dw_col": g_col[1], "y_row": y_row.detach(), "dh_row": g_row[0],
            "dw_row": g_row[1]}


def op_attention(inp: dict, cfg, split) -> dict:
    q, k, v = (_leaf(_cols(inp[n], split), torch.bfloat16)
               for n in ("q", "k", "v"))
    t = _bf16(inp["t"]).float()
    pos = torch.arange(S)[None, :]
    hd = cfg.resolved_head_dim
    if split is None:
        out = L.flash_attention(TLM._rope(q, pos, cfg, cfg.num_heads, hd),
                                TLM._rope(k, pos, cfg, cfg.num_kv_heads, hd),
                                TLM._split_heads(v, cfg.num_kv_heads, hd))
        out = out.reshape(B, S, -1)
    else:
        out = TLM._attention(q, k, v, pos, cfg, True, split)
    grads = _grads((out.float() * _cols(t, split)).sum(), [q, k, v])
    return {"out": out.detach(), "dq": grads[0], "dk": grads[1],
            "dv": grads[2]}


def op_embed(inp: dict, split) -> dict:
    table = _leaf(_cols(inp["table"], split, 0))
    params = {"embed": table}
    out = TLM._embed(params, torch.from_numpy(inp["tokens"]), split)
    grads = _grads((out.float() * _bf16(inp["t_embed"]).float()).sum(),
                   [table])
    return {"out": out.detach(), "dtable": grads[0]}


def op_loss(inp: dict, split) -> dict:
    x = _leaf(inp["x"], torch.bfloat16)
    head = _leaf(_cols(inp["head"], split))
    loss = TLM.chunked_xent(x, head,
                            torch.from_numpy(inp["labels"]), chunk=CHUNK,
                            split=split)
    grads = _grads(loss, [x, head])
    return {"loss": loss.detach(), "dx": grads[0], "dhead": grads[1]}


def op_moe(inp: dict, split) -> dict:
    m = inp["moe"]
    c = MOE_CFG
    x = _leaf(m["x"], torch.bfloat16)
    gate_w = _leaf(m["gate_w"])
    stacks = [_leaf(_cols(m[k], split, 0))
              for k in ("we_gate", "we_up", "we_down")]
    route = (c.experts_per_token, c.capacity_factor, c.moe_group_size)
    if split is None:
        y = L.moe_ffn(x, gate_w, *stacks, *route)
    else:
        y = split.reduce_out(L.moe_ffn(
            split.copy_in(x), split.copy_in(gate_w),
            *stacks, *route,
            experts=split.block(c.num_experts)))
    grads = _grads((y.float() * _bf16(m["t"]).float()).sum(),
                   [x, gate_w, *stacks])
    return {"y": y.detach(), "dx": grads[0], "dgate_w": grads[1],
            **{f"d{k}": g for k, g in zip(("we_gate", "we_up", "we_down"),
                                          grads[2:])}}


def run_ops(split) -> dict:
    inp = _inputs()
    return {"linears": op_linears(inp, split),
            **{f"attn_{n}": op_attention(inp[n], cfg, split)
               for n, cfg in ATTN_CFGS.items()},
            "embed": op_embed(inp, split), "loss": op_loss(inp, split),
            "moe": op_moe(inp, split)}


def _jamba_cfg():
    return get_reduced("jamba-1.5-large-398b")


def _jamba_batch(cfg) -> dict:
    r = _rng("jamba")
    tok = r.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": torch.from_numpy(tok[:, :-1]),
            "labels": torch.from_numpy(tok[:, 1:].copy())}


def _train_small_step(policy) -> int:
    """``FlopCounterMode``'s count of one train step of reduced minicpm-2b
    at ``TRAIN`` under ``policy``."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = get_reduced("minicpm-2b")
    params = policy.place(TLM.init_params(cfg, 0, device="cpu"))
    for leaf in TR.leaves(params):
        leaf.requires_grad_(True)
    opt = adamw_init(params, AdamWConfig())
    r = _rng("train")
    tok = r.integers(0, cfg.vocab_size, (TRAIN.global_batch,
                                         TRAIN.seq_len)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tok),
             "labels": torch.from_numpy(np.roll(tok, -1, 1))}
    step = build_step(cfg, policy, AdamWConfig(), False)
    with FlopCounterMode(display=False) as fc:
        step(params, opt, {"_": torch.zeros(())}, batch)
    return fc.get_total_flops()


# ---------------------------------------------------------------------------
# the worker: one rank of the group
# ---------------------------------------------------------------------------


def _worker(work: Path, rank: int) -> None:
    dist.init_process_group("gloo", init_method=f"file://{work}/store",
                            rank=rank, world_size=WORLD)
    try:
        pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        out = {}
        for size in SIZES:
            group = dist.group.WORLD if size == WORLD else pairs[rank // 2]
            split = SH.ModelSplit(group, rank % size, size)
            out[size] = run_ops(split)
        policy = SH.ShardingPolicy(mesh=make_local_mesh(WORLD, "cpu"))
        cfg = _jamba_cfg()
        params = policy.place(TLM.init_params(cfg, 0, device="cpu"))
        flat = TR.flatten_with_paths(params)
        for _, leaf in flat:
            leaf.requires_grad_(True)
        loss = TLM.train_loss(params, _jamba_batch(cfg), cfg, policy)
        grads = torch.autograd.grad(loss, [t for _, t in flat])
        out["jamba_grads"] = {TR.path_name(p): SH.local(g).clone()
                              for (p, _), g in zip(flat, grads)}
        out["flops"] = _train_small_step(policy)
        torch.save(out, work / f"out_{rank}.pt")
    finally:
        dist.destroy_process_group()


REFERENCE_HLO = """
import dataclasses, json
import jax
from repro.analysis import hlo as JH
from repro.configs import get_reduced
from repro.launch import specs as JS
from repro.launch.mesh import make_local_mesh
from repro.models import lm
from repro.models.config import SHAPES
from repro.optim import AdamWConfig, adamw_update
from repro.sharding import ShardingPolicy
cfg = get_reduced("minicpm-2b")
shape = dataclasses.replace(SHAPES["train_4k"], name="train_small",
                            seq_len={seq}, global_batch={batch})
policy = ShardingPolicy(mesh=make_local_mesh(4))
params = JS.param_struct(cfg)
params_sh = policy.params_shardings(params)
opt = JS.opt_struct(params, AdamWConfig())
opt_sh = JS.opt_shardings(opt, params_sh, policy)
batch = JS.input_specs(cfg, shape)

def step(params, opt_state, batch):
    loss, grads = jax.value_and_grad(lm.train_loss)(params, batch, cfg,
                                                    policy)
    new_p, new_s, metrics = adamw_update(grads, opt_state, params,
                                         AdamWConfig())
    return new_p, new_s, {{"loss": loss, **metrics}}

fn = jax.jit(step, in_shardings=(params_sh, opt_sh,
                                 JS.batch_shardings(batch, policy)),
             out_shardings=(params_sh, opt_sh, None))
text = fn.lower(params, opt, batch).compile().as_text()
print(json.dumps(JH.analyze_hlo_text(text)["dot_flops_per_device"]))
"""


def _env(**extra) -> dict:
    return dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}",
                OMP_NUM_THREADS="1", **extra)


@pytest.fixture(scope="module")
def group_run(tmp_path_factory):
    """The four ranks' results, the reference's per-device dot FLOPs of
    its (1, 4) train step, and the one-process operators."""
    work = tmp_path_factory.mktemp("model_parallel")
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE_HLO.format(seq=TRAIN.seq_len,
                                                    batch=TRAIN.global_batch)],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                 JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    workers = [subprocess.Popen(
        [sys.executable, __file__, "worker", str(work), str(r)], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    try:
        one = run_ops(None)
        logs = [w.communicate(timeout=600)[0] for w in workers]
        ref_out, ref_err = ref.communicate(timeout=600)
    finally:
        for p in [*workers, ref]:
            if p.poll() is None:
                p.kill()
    for w, log in zip(workers, logs):
        assert w.returncode == 0, log[-3000:]
    assert ref.returncode == 0, ref_err[-3000:]
    return {"ranks": [torch.load(work / f"out_{r}.pt")
                      for r in range(WORLD)],
            "one": one,
            "reference_flops": json.loads(ref_out.strip().splitlines()[-1])}


# ---------------------------------------------------------------------------
# reassembling the ranks' results
# ---------------------------------------------------------------------------


def _whole(group_run, size: int, op: str, key: str, dim=None):
    """The tensor ``key`` of ``op`` on a model axis of ``size``: rank 0's
    (every rank's alike, checked) when ``dim`` is None, else the first
    ``size`` ranks' blocks concatenated along ``dim`` (the second pair of
    a 2-rank axis holds the same, checked)."""
    got = [o[size][op][key] for o in group_run["ranks"]]
    if dim is None:
        for g in got[1:]:
            assert torch.equal(g, got[0]), (op, key, "ranks differ")
        return got[0]
    if size < WORLD:
        for a, b in zip(got[:size], got[size:]):
            assert torch.equal(a, b), (op, key, "pairs differ")
    return torch.cat(got[:size], dim=dim)


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) / \
        max(float(want.float().abs().max()), 1e-30)


@pytest.mark.parametrize("size", SIZES)
def test_column_and_row_linears(group_run, size):
    """Column-parallel: each rank's output columns and its weight block's
    gradient are the one-process ones, bit for bit; the input's gradient
    (copy-in's all-reduce of the ranks' parts) within ``GRAD_TOL``.
    Row-parallel: the reduce-out sum within ``ROW_TOL``, its input's and
    weight's gradients the one-process slices, bit for bit."""
    one = group_run["one"]["linears"]
    assert _rel(_whole(group_run, size, "linears", "y_col", -1),
                one["y_col"]) == EXACT
    assert _rel(_whole(group_run, size, "linears", "dx_col"),
                one["dx_col"]) <= GRAD_TOL
    assert _rel(_whole(group_run, size, "linears", "dw_col", -1),
                one["dw_col"]) == EXACT
    assert _rel(_whole(group_run, size, "linears", "y_row"),
                one["y_row"]) <= ROW_TOL
    assert _rel(_whole(group_run, size, "linears", "dh_row", -1),
                one["dh_row"]) == EXACT
    assert _rel(_whole(group_run, size, "linears", "dw_row", 0),
                one["dw_row"]) == EXACT


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", sorted(ATTN_CFGS))
def test_attention_over_each_ranks_heads(group_run, name, size):
    """Each rank's block of the flat attention output, the heads
    straddling two ranks' blocks included, is the one-process output's bit
    for bit; q's, k's and v's gradients (a gathered tensor's summed over
    the ranks by the reduce-scatter) within ``GRAD_TOL``."""
    op = f"attn_{name}"
    one = group_run["one"][op]
    assert _rel(_whole(group_run, size, op, "out", -1), one["out"]) == EXACT
    for key in ("dq", "dk", "dv"):
        assert _rel(_whole(group_run, size, op, key, -1),
                    one[key]) <= GRAD_TOL, key


@pytest.mark.parametrize("size", SIZES)
def test_vocab_parallel_embedding(group_run, size):
    """The summed lookups are the one-process embeddings bit for bit (one
    rank's row and zeros), each rank's table block's gradient the
    one-process gradient's rows."""
    one = group_run["one"]["embed"]
    assert torch.equal(_whole(group_run, size, "embed", "out"), one["out"])
    assert torch.equal(_whole(group_run, size, "embed", "dtable", 0),
                       one["dtable"])


@pytest.mark.parametrize("size", SIZES)
def test_vocab_parallel_loss(group_run, size):
    """The chunked loss from each rank's vocabulary block within
    ``LOSS_TOL`` of the one-process loss; the input's gradient (copy-in)
    within ``GRAD_TOL``, each head block's the one-process one's, bit for
    bit."""
    one = group_run["one"]["loss"]
    got = _whole(group_run, size, "loss", "loss")
    assert abs(float(got) - float(one["loss"])) <= \
        LOSS_TOL * float(one["loss"])
    assert _rel(_whole(group_run, size, "loss", "dx"), one["dx"]) <= GRAD_TOL
    assert _rel(_whole(group_run, size, "loss", "dhead", -1),
                one["dhead"]) == EXACT


def test_vocab_parallel_loss_against_the_reference(group_run):
    """The reference's ``chunked_xent`` under ``jax.jit`` on the same
    numpy inputs: the 4-rank vocab-parallel loss within ``LOSS_TOL``, its
    head gradient within ``GRAD_TOL``."""
    inp = _inputs()
    x = jnp.asarray(inp["x"], jnp.float32).astype(jnp.bfloat16)
    head = jnp.asarray(inp["head"], jnp.float32)
    labels = jnp.asarray(inp["labels"])
    fn = jax.jit(jax.value_and_grad(
        lambda h: JLM.chunked_xent(x, h, labels, CHUNK)))
    want, dhead = fn(head)
    got = _whole(group_run, WORLD, "loss", "loss")
    assert abs(float(got) - float(want)) <= LOSS_TOL * float(want)
    assert _rel(_whole(group_run, WORLD, "loss", "dhead", -1),
                torch.from_numpy(np.array(dhead))) <= GRAD_TOL


@pytest.mark.parametrize("size", SIZES)
def test_expert_parallel_moe(group_run, size):
    """Each rank's experts (every row routed on every rank, a ×30 router)
    summed by reduce-out: within ``ROW_TOL`` of the one-process MoE; the
    input's gradient (copy-in) within ``GRAD_TOL``, the router's (an f32
    product summed by its copy-in) within ``LOSS_TOL``, each rank's
    expert blocks' gradients the one-process ones' rows, bit for bit."""
    one = group_run["one"]["moe"]
    assert _rel(_whole(group_run, size, "moe", "y"), one["y"]) <= ROW_TOL
    assert _rel(_whole(group_run, size, "moe", "dx"), one["dx"]) <= GRAD_TOL
    assert _rel(_whole(group_run, size, "moe", "dgate_w"),
                one["dgate_w"]) <= LOSS_TOL
    for key in ("dwe_gate", "dwe_up", "dwe_down"):
        assert _rel(_whole(group_run, size, "moe", key, 0), one[key]) == \
            EXACT, key


def test_split_refusals(tmp_path):
    """A dim the model axis does not divide is refused (as
    ``NamedSharding.shard_shape`` refuses it).  STaMP and a cache, refused
    under a split while the split was the training step's alone, now run
    under one: on a one-rank split (a gloo group of this process) the
    STaMP prefill block with its cache and the STaMP FFN are the unsplit
    ones, bit for bit (serving's split itself is held in
    ``tests/test_torch_serve_split.py``)."""
    split = SH.ModelSplit(None, 1, 4)
    assert split.block(8) == (2, 4)
    with pytest.raises(ValueError, match="does not split 4 ways"):
        split.block(6)
    cfg = get_reduced("minicpm-2b")
    layer = TLM.init_params(cfg, 0, device="cpu")["layers"][0]
    spec = cfg.layer_specs()[0]
    x = _bf16(_rng("refusals").standard_normal((1, 8, cfg.d_model)))
    kv = KVCacheConfig()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        got = []
        for s in (None, SH.ModelSplit(dist.group.WORLD, 0, 1)):
            y, entry = TLM.attn_block_prefill(layer, x, cfg, StampConfig(),
                                              kv, 16, split=s)
            got.append([y, TLM.ffn_block(layer, y, spec, cfg, StampConfig(),
                                         False, split=s), *entry.values()])
    finally:
        dist.destroy_process_group()
    assert all(torch.equal(a, b) for a, b in zip(*got))


def test_replicated_leaves_get_one_gradient(group_run):
    """Reduced Jamba on (1, 4): every leaf the rule table replicates along
    ``model`` — norms, the routers, the Mamba mixers' per-head leaves —
    has the same gradient on all four ranks, bit for bit."""
    policy = SH.ShardingPolicy(mesh=None)
    cfg = _jamba_cfg()
    template = TLM.init_params(cfg, 0, device="cpu")
    seen = set()
    for path, leaf in TR.flatten_with_paths(template):
        name = TR.path_name(path)
        if "model" in [a for e in policy.param_spec(name, leaf.dim())
                       for a in SH._axes(e)]:
            continue
        got = [o["jamba_grads"][name] for o in group_run["ranks"]]
        assert all(torch.equal(g, got[0]) for g in got[1:]), name
        assert float(got[0].abs().max()) > 0, name
        seen.add(name.rsplit("/", 1)[-1])
    assert {"ln1", "ln2", "final_norm", "gate_w", "conv_w", "a_log",
            "dt_bias", "d_skip", "ssm_norm"} <= seen


def test_dry_run_flops_equal_a_real_rank(group_run):
    """The dry run of reduced minicpm-2b's train step on a fake (1, 4)
    group counts each real gloo rank's ``FlopCounterMode`` total exactly,
    a quarter of the one-device step's (4 heads over 4 ranks: every
    product splits evenly)."""
    rec = DR.lower_cell("minicpm-2b", None, multi_pod=False,
                        cfg=get_reduced("minicpm-2b"), shape=TRAIN,
                        mesh_shape=(1, 4), device="cpu")
    assert rec["model_split"]["split"] and \
        rec["model_split"]["model_ranks"] == 4
    got = OS.op_stats(rec["counter"].log())["dot_flops_per_device"]
    assert all(o["flops"] == got for o in group_run["ranks"])
    one = DR.lower_cell("minicpm-2b", None, multi_pod=False,
                        cfg=get_reduced("minicpm-2b"), shape=TRAIN,
                        sharded=False, device="cpu")
    assert OS.op_stats(one["counter"].log())["dot_flops_per_device"] == \
        4 * got


def test_dot_flops_against_the_reference_model_parallel_step(group_run):
    """The reference's train step compiled on 4 forced host devices with
    ``model`` 4 (``analyze_hlo_text``'s per-device count) and the port's
    dry run on a fake (1, 4) group, term by term: the port recomputes the
    loss chunk's head product in the backward (+2·T·d·V/4: the reference's
    compiled program computes a one-chunk scan's logits once), and the
    reference's backward takes one more attention-sized product a layer
    (an f32 (b, hd, s) key gradient: −2·b·s²·hd·(heads/4) a layer).  The
    two terms are 2.0% and 1.0% of the reference's count."""
    cfg = get_reduced("minicpm-2b")
    rec = DR.lower_cell("minicpm-2b", None, multi_pod=False, cfg=cfg,
                        shape=TRAIN, mesh_shape=(1, 4), device="cpu")
    got = OS.op_stats(rec["counter"].log())["dot_flops_per_device"]
    want = group_run["reference_flops"]
    tokens, s = TRAIN.global_batch * TRAIN.seq_len, TRAIN.seq_len
    head = 2 * tokens * cfg.d_model * cfg.padded_vocab // 4
    attn = 2 * TRAIN.global_batch * s * s * cfg.resolved_head_dim * \
        (cfg.num_heads // 4) * cfg.num_layers
    assert got - want == head - attn, (got, want, head, attn)
    assert abs(got - want) <= 0.02 * want


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(Path(sys.argv[2]), int(sys.argv[3]))

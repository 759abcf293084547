"""The port's sharded training step (``repro_torch.sharding``,
``repro_torch.launch.mesh``, ``build_step`` / ``train`` under a mesh) on
the CPU, in gloo process groups.

* One group of four worker processes (this file run as a script, joined
  through a ``FileStore``) serves the checks that need a mesh, on a
  ``(4, 1)``, a ``(2, 2)`` and a ``(1, 4)`` ``("data", "model")`` mesh;
  the test process computes the one-process side meanwhile:
  - three steps of reduced minicpm-2b (dense, tied; with and without
    gradient compression), arctic-480b (MoE, its router scaled by
    ``ROUTER_SCALE`` on both sides, as ``test_torch_train.py`` does and
    says why) and mamba2-1.3b (SSM, its mixers split over their heads
    where ``model`` has more than one rank), two layers each.  Each
    rank's stored block of every parameter and moment
    is the slice the rule table names: the four ranks' blocks reassemble
    the tensor, replicas equal (a leaf replicated along ``model`` —
    norms, the router — gets the same update on every model rank), and
    the blocks placed at the start reassemble the init exactly.  On
    ``(4, 1)`` only the batch splits: the data ranks' sums meet in
    another order (each data rank's weight gradient is a bf16 product
    over its own rows, the quarters summed in f32 where one process
    rounds their sum once); the first step's bounds below are set from
    the measured gaps.  Where ``model`` has more than one rank the step
    splits its compute (``lm.train_loss`` under
    ``ShardingPolicy.model_split``): a row-parallel product sums its
    ranks' bf16 partials, each rounded, where one process rounds the
    whole sum once, so the forward itself parts from the one-process
    one by bf16 steps.  So on ``(1, 4)`` and ``(2, 2)`` a first step
    run in f32 compute (``lm.COMPUTE_DTYPE``) on both sides is held to
    the data split's first-step bounds, and the bf16 runs to the bounds
    the data split keeps for its later steps (``LOSS_REL``,
    ``GNORM_REL``) from the first step on (:func:`_split_steps`);
  - gradient compression on the one-process gradients, placed: the int8
    codes, the scales and the residuals equal the one-process ones (a
    leaf's scale comes from its global ``absmax``);
  - a hand-made batch whose ignored labels fall unevenly over the data
    ranks: the loss is the one-process loss (``XENT_REL``), where the
    ranks' mean of means is far from it;
  - the reference's ``--model-parallel 2`` run (``repro.launch.train``
    under four forced host devices, in a subprocess) against the port's
    2 x 2 ``train`` from the same parameters (carried by
    ``from_jax_params`` in a step-0 checkpoint) on the same data: the
    losses within ``LOSS_REL`` (measured 1.2e-4 at most).
* The reference's elastic test and the crash test through ``python -m
  torch.distributed.run --standalone``: one process to a 2 x 2 mesh and
  back, each resumed from step 4 and ending within ``LOSS_REL`` of a
  clean one-process run; a crash under the 2 x 2 mesh resumed to the
  clean 2 x 2 run's final checkpoint, every leaf's CRC equal.
* One process without a group refuses ``--model-parallel 2``; a one-rank
  group's policy step is bit-equal to the one-device step.
"""

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import sharding as SH
from repro_torch import tree as TR
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import DataConfig, DataIterator
from repro_torch.launch import train as TTRAIN
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import lm as TLM
from repro_torch.optim import AdamWConfig, adamw_init, make_schedule
from repro_torch.optim.compression import (compress_gradients,
                                           init_error_state)

# One PyTorch thread a process: the tier-1 run puts six pytest workers on
# the machine's cores (see test_torch_train.py).
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WORLD, MP = 4, 2
MESHES = {"4x1": 1, "2x2": 2, "1x4": 4}          # name: model_parallel
STEPS, BATCH, SEQ, LR, WARMUP = 3, 4, 32, 3e-3, 1
ROUTER_SCALE = 30.0
LOSS_REL = 1e-3          # test_torch_train.py's
FLIP_FRAC = 0.02         # test_torch_train.py's
GNORM_REL = 1e-2
FIRST_LOSS_REL, FIRST_GNORM_REL = 1e-6, 1e-4   # measured 7.7e-8, 5.6e-5 (4, 1)
XENT_REL = 1e-6
SCENARIOS = {"minicpm": ("minicpm-2b", False),
             "minicpm_ef": ("minicpm-2b", True),
             "arctic": ("arctic-480b", False),
             "mamba": ("mamba2-1.3b", False)}
JAX_ARCH = "minicpm-2b"


def _cfg(arch: str):
    return dataclasses.replace(get_reduced(arch), num_layers=2)


def _opt(cfg) -> AdamWConfig:
    return AdamWConfig(lr=LR, schedule=make_schedule(cfg.schedule, LR,
                                                     WARMUP, 10))


def _init(arch: str) -> dict:
    """The port's seeded init (an MoE router scaled)."""
    params = TLM.init_params(_cfg(arch), 0, device="cpu")
    for p in params["layers"]:
        if "gate_w" in p:
            p["gate_w"] = p["gate_w"] * ROUTER_SCALE
    return params


@contextlib.contextmanager
def _compute(dtype):
    """The port's forward in ``dtype`` (``lm.COMPUTE_DTYPE``) inside."""
    old, TLM.COMPUTE_DTYPE = TLM.COMPUTE_DTYPE, dtype
    try:
        yield
    finally:
        TLM.COMPUTE_DTYPE = old


def _batches(cfg) -> list:
    data = DataIterator(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                   global_batch=BATCH))
    return [next(data) for _ in range(STEPS)]


def _uneven_batch(cfg) -> dict:
    """Rows 0–1 (data rank 0) keep every label; rows 2–3 (data rank 1)
    keep three each."""
    rng = np.random.default_rng(7)
    tok = rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
    labels = tok[:, 1:].copy()
    labels[2:, 3:] = -1
    return {"tokens": tok[:, :-1], "labels": labels}


def _tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _train_cfg() -> TTRAIN.TrainConfig:
    return TTRAIN.TrainConfig(steps=STEPS, global_batch=BATCH, seq=SEQ,
                              lr=LR, warmup=WARMUP, ckpt_every=100,
                              model_parallel=MP)


def _locals(tree) -> list:
    return [SH.local(t).detach().clone() for t in TR.leaves(tree)]


def _run(params, cfg, compress: bool, policy=None, steps=STEPS) -> dict:
    """``steps`` steps of ``build_step``: the loss and grad norm of each,
    the final parameters and moments (each rank's blocks under a
    policy)."""
    opt_cfg = _opt(cfg)
    for leaf in TR.leaves(params):
        leaf.requires_grad_(True)
    state = adamw_init(params, opt_cfg)
    err = init_error_state(params) if compress else {"_": torch.zeros(())}
    step = TTRAIN.build_step(cfg, policy, opt_cfg, compress)
    out = {"metrics": []}
    for i, batch in enumerate(_batches(cfg)[:steps]):
        if policy is not None:
            batch = policy.batch_rows(batch)
        params, state, err, m = step(params, state, err, _tensors(batch))
        out["metrics"].append((float(m["loss"]), float(m["grad_norm"])))
        if i == 0:
            out["params1"] = _locals(params)
    return dict(out, params=_locals(params), m=_locals(state["m"]),
                v=_locals(state["v"]))


# ---------------------------------------------------------------------------
# the worker: one rank of the 2 x 2 group
# ---------------------------------------------------------------------------


def _worker(work: Path, rank: int) -> None:
    dist.init_process_group("gloo", init_method=f"file://{work}/store",
                            rank=rank, world_size=WORLD)
    try:
        out = {}
        for mesh, mp in MESHES.items():
            policy = SH.ShardingPolicy(mesh=make_local_mesh(mp, "cpu"))
            out[mesh] = {"coord": policy.mesh.get_coordinate()}
            for name, (arch, compress) in SCENARIOS.items():
                placed = policy.place(_init(arch))
                out[mesh][name + "_init"] = _locals(placed)
                out[mesh][name] = _run(placed, _cfg(arch), compress, policy)
                if mp > 1:
                    with _compute(torch.float32):
                        out[mesh][name + "_f32"] = _run(
                            policy.place(_init(arch)), _cfg(arch), compress,
                            policy, steps=1)
        policy = SH.ShardingPolicy(mesh=make_local_mesh(MP, "cpu"))
        inputs = torch.load(work / "compress_in.pt")
        qs, scales, res = compress_gradients(policy.place(inputs["grads"]),
                                             policy.place(inputs["err"]))
        out["2x2"]["compress"] = {"q": _locals(qs), "res": _locals(res),
                                  "scale": TR.leaves(scales)}
        cfg = _cfg("minicpm-2b")
        policy = SH.ShardingPolicy(mesh=make_local_mesh(1, "cpu"))
        params = policy.place(_init("minicpm-2b"))
        with torch.no_grad():
            out["uneven"] = float(TLM.train_loss(
                params, _tensors(policy.batch_rows(_uneven_batch(cfg))),
                cfg, policy))
        jax_run = TTRAIN.train(_cfg(JAX_ARCH), _train_cfg(),
                               ckpt_dir=str(work / "jax_init"),
                               verbose=False, device="cpu")
        out["jax_run_losses"] = jax_run["losses"]
        torch.save(out, work / f"out_{rank}.pt")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the group's run and the one-process side
# ---------------------------------------------------------------------------


def _env(**extra) -> dict:
    return dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}",
                OMP_NUM_THREADS="1", **extra)


REFERENCE_RUN = """
import dataclasses, json
from repro.configs import get_reduced
from repro.launch import train as T
cfg = dataclasses.replace(get_reduced({arch!r}), num_layers=2)
tc = T.TrainConfig(steps={steps}, global_batch={batch}, seq={seq}, lr={lr},
                   warmup={warmup}, ckpt_every=100, model_parallel=2)
print(json.dumps(T.train(cfg, tc, ckpt_dir=None, verbose=False)["losses"]))
"""


def _jax_init_checkpoint(work: Path) -> None:
    """The reference's ``init_params(PRNGKey(0))`` carried by
    ``from_jax_params`` into a step-0 checkpoint of the port's trainer
    (its moments zero, the data iterator at step 0)."""
    import jax
    jax.config.update("jax_platform_name", "cpu")
    from repro.configs import get_reduced as jget_reduced
    from repro.models import lm as JLM
    jcfg = dataclasses.replace(jget_reduced(JAX_ARCH), num_layers=2)
    host = jax.tree.map(np.asarray, JLM.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    params = TLM.from_jax_params(host, _cfg(JAX_ARCH))
    state = {"params": params, "opt": adamw_init(params, AdamWConfig())}
    CheckpointManager(work / "jax_init").save(
        0, state, extra={"step": 0, "data": {"step": 0}})


@pytest.fixture(scope="module")
def group_run(tmp_path_factory):
    """The 2 x 2 group's results by rank, the reference's ``--model-
    parallel 2`` losses, and the one-process runs."""
    work = tmp_path_factory.mktemp("mesh")
    cfg = _cfg("minicpm-2b")
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE_RUN.format(
            arch=JAX_ARCH, steps=STEPS, batch=BATCH, seq=SEQ, lr=LR,
            warmup=WARMUP)],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                 JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    # the compression check's inputs: one-process gradients and residuals
    params = _init("minicpm-2b")
    for leaf in TR.leaves(params):
        leaf.requires_grad_(True)
    loss = TLM.train_loss(params, _tensors(_batches(cfg)[0]), cfg)
    grads = TR.unflatten_like(params, [g.detach() for g in torch.autograd.grad(
        loss, TR.leaves(params))])
    gen = torch.Generator().manual_seed(3)
    err = TR.tree_map(lambda g: torch.randn(g.shape, generator=gen) * float(
        g.abs().max()) * 0.01, grads)
    torch.save({"grads": grads, "err": err}, work / "compress_in.pt")
    _jax_init_checkpoint(work)
    workers = [subprocess.Popen(
        [sys.executable, __file__, "worker", str(work), str(r)], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    try:
        one = {name: _run(_init(arch), _cfg(arch), compress)
               for name, (arch, compress) in SCENARIOS.items()}
        with _compute(torch.float32):
            one.update({name + "_f32": _run(_init(arch), _cfg(arch),
                                            compress, steps=1)
                        for name, (arch, compress) in SCENARIOS.items()})
        one["compress"] = compress_gradients(grads, err)
        with torch.no_grad():
            full = _init("minicpm-2b")
            one["uneven"] = float(TLM.train_loss(
                full, _tensors(_uneven_batch(cfg)), cfg))
            one["halves"] = [float(TLM.train_loss(
                full, _tensors({k: v[h:h + 2] for k, v in
                                _uneven_batch(cfg).items()}), cfg))
                for h in (0, 2)]
        logs = [w.communicate(timeout=600)[0] for w in workers]
        ref_out, ref_err = ref_proc.communicate(timeout=600)
    finally:
        for p in [*workers, ref_proc]:
            if p.poll() is None:
                p.kill()
    for w, log in zip(workers, logs):
        assert w.returncode == 0, log[-3000:]
    assert ref_proc.returncode == 0, ref_err[-3000:]
    ranks = [torch.load(work / f"out_{r}.pt") for r in range(WORLD)]
    return {"ranks": ranks, "one": one,
            "reference": json.loads(ref_out.strip().splitlines()[-1])}


# ---------------------------------------------------------------------------
# assembling a tensor from the ranks' blocks by the rule table
# ---------------------------------------------------------------------------


def _block(spec, coord, sizes, shape) -> tuple:
    """The slice of a ``shape`` tensor that ``spec`` gives the rank at
    ``coord`` of a ``("data", "model")`` mesh of ``sizes`` (each named
    axis splits its dim evenly, the first name major)."""
    names = ("data", "model")
    out = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = () if entry is None else (entry,) if isinstance(entry, str) \
            else entry
        idx, parts = 0, 1
        for ax in axes:
            i = names.index(ax)
            idx, parts = idx * sizes[i] + coord[i], parts * sizes[i]
        assert n % parts == 0, (spec, shape)
        out.append(slice(idx * (n // parts), (idx + 1) * (n // parts)))
    return tuple(out)


def _assemble(group_run, mesh: str, name: str, key: str, ref_tree) -> list:
    """Each leaf of ``ref_tree``'s structure rebuilt from the ranks'
    stored blocks: every block has the rule table's shape and place, and
    replicas of one block are equal."""
    sizes = (WORLD // MESHES[mesh], MESHES[mesh])
    policy = SH.ShardingPolicy(mesh=None)      # the rule table needs none
    out = []
    for i, (path, ref) in enumerate(TR.flatten_with_paths(ref_tree)):
        spec = policy.param_spec(TR.path_name(path), ref.dim())
        full = torch.empty(ref.shape, dtype=ref.dtype)
        seen = torch.zeros(ref.shape, dtype=torch.bool)
        for o in group_run["ranks"]:
            sl = _block(spec, o[mesh]["coord"], sizes, ref.shape)
            blk = o[mesh][name][key][i] if name else o[mesh][key][i]
            assert tuple(blk.shape) == tuple(full[sl].shape), (path, spec)
            if seen[sl].all():
                assert torch.equal(full[sl], blk), (path, "replicas differ")
            full[sl], seen[sl] = blk, True
        assert seen.all(), path
        out.append(full)
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_blocks_at_placement_are_the_rule_tables(group_run, mesh, name):
    """The blocks placed at the start reassemble the init exactly."""
    init = _init(SCENARIOS[name][0])
    for got, want in zip(_assemble(group_run, mesh, "", name + "_init",
                                   init), TR.leaves(init)):
        assert torch.equal(got, want)


def _first_step_params(group_run, mesh: str, name: str,
                       key: str = "") -> float:
    """The parameters after the first step on ``mesh`` (of run ``key``,
    ``name`` by default), reassembled, within ``test_torch_train.py``'s
    bounds for a step: every element within 2·lr, all but ``FLIP_FRAC``
    within 1e-3·lr (AdamW's first step moves an element by about ±lr, so
    an element whose gradient lies within the runs' rounding of zero may
    step the other way).  Returns the share past 1e-3·lr."""
    key = key or name
    one = group_run["one"][key]
    template = _init(SCENARIOS[name][0])
    far = total = 0
    for (path, _), a, b in zip(
            TR.flatten_with_paths(template),
            _assemble(group_run, mesh, key, "params1", template),
            one["params1"]):
        d = (a - b).abs()
        assert float(d.max()) <= 2 * LR * (1 + 1e-3), path
        far += int((d > 1e-3 * LR).sum())
        total += d.numel()
    assert far <= FLIP_FRAC * total, far / total
    return far / total


def _first_step(group_run, mesh: str, name: str, key: str = "") -> None:
    """The first step of run ``key`` (``name`` by default) on ``mesh``
    held as the data split's is: every rank's metrics alike, the loss
    within ``FIRST_LOSS_REL`` and the grad norm within ``FIRST_GNORM_REL``
    of the one-process step's, the parameters after it as
    :func:`_first_step_params` holds them."""
    key = key or name
    one = group_run["one"][key]["metrics"]
    ranks = [o[mesh][key] for o in group_run["ranks"]]
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    (l1, g1), (l2, g2) = one[0], ranks[0]["metrics"][0]
    assert abs(l2 - l1) <= FIRST_LOSS_REL * l1, (l1, l2)
    assert abs(g2 - g1) <= FIRST_GNORM_REL * g1, (g1, g2)
    _first_step_params(group_run, mesh, name, key)


def _split_steps(group_run, mesh: str, name: str) -> None:
    """A run whose ``model`` axis splits the compute, held to the
    one-process run from the same init.  In f32 compute (the ``_f32``
    runs: one step) the split is the one-process function up to f32
    rounding: its first step is held as the data split's
    (:func:`_first_step`), Arctic's ×30 router included.  In bf16 every
    rank's metrics are alike and the parameters after the first step
    are held by :func:`_first_step_params`; the loss within ``LOSS_REL``
    and the grad norm within ``GNORM_REL`` at every step, but Arctic's:
    its ×30 router turns the split's bf16 rounding into a grad norm 13–14%
    from the one-process one at the first step (loss 1.1e-3 / 8.1e-4 on
    (1, 4) / (2, 2), 12.6% of its elements past 1e-3·lr), where in f32
    the same split sits within ``FIRST_LOSS_REL`` and
    ``FIRST_GNORM_REL``; that gap is rounding amplified by the router's
    near-ties (``PERF.md``, open questions)."""
    _first_step(group_run, mesh, name, name + "_f32")
    one = group_run["one"][name]["metrics"]
    ranks = [o[mesh][name] for o in group_run["ranks"]]
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    if name == "arctic":
        return
    for (l1, g1), (l2, g2) in zip(one, ranks[0]["metrics"]):
        assert abs(l2 - l1) <= LOSS_REL * l1, (l1, l2)
        assert abs(g2 - g1) <= GNORM_REL * g1, (g1, g2)
    _first_step_params(group_run, mesh, name)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_model_axis_alone_is_the_one_process_step(group_run, name):
    """On the (1, 4) mesh nothing splits the batch and the model axis
    splits the compute: each rank computes its blocks of the linears, the
    heads they overlap, its vocabulary block and its experts.  Held as
    :func:`_split_steps` says (measured in f32 at the first step: the
    losses equal, the grad norm 4.7e-6 at most (Arctic; 0 for the
    others), 0–0.03% of the elements past 1e-3·lr; in bf16 over the three
    steps: loss 1.6e-4 at most for the dense scenarios, 1.7e-4 for
    mamba2, whose mixers split over their heads (its f32 first step: loss
    and grad norm equal); grad norm 3.9e-3, 2.8e-3; 0.7–1.5% of the
    elements past 1e-3·lr after the first step (mamba2 1.3%); Arctic, not
    held there, 1.1e-3 and 0.13 at the first step)."""
    _split_steps(group_run, "1x4", name)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_data_and_model_split(group_run, name):
    """On the 2 x 2 mesh both axes split: held as the (1, 4) mesh is
    (measured in f32 at the first step: loss 1.5e-7 at most, grad norm
    3.7e-6 (Arctic; 8.9e-8 for the others), 0–0.03% of the elements
    past 1e-3·lr; in bf16: loss 7.5e-5 and 1.9e-5 at most for the dense
    scenarios and mamba2 (its mixers split over their heads); grad norm
    3.4e-3, 1.9e-3; 0.8–1.3% of the elements past 1e-3·lr after the
    first step (mamba2 1.2%); Arctic, not held there, 8.1e-4 and 0.14 at
    the first step)."""
    _split_steps(group_run, "2x2", name)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_data_split_first_step(group_run, name):
    """On the (4, 1) mesh, where only the batch splits, the first step:
    the loss within ``FIRST_LOSS_REL`` and the grad norm within
    ``FIRST_GNORM_REL`` of the one-process step's, every replica's
    alike; the parameters after it reassembled within
    :func:`_first_step_params`' bounds (measured: loss 7.7e-8, grad norm
    5.6e-5 at most, 0.08–0.8% of the elements past 1e-3·lr)."""
    _first_step(group_run, "4x1", name)


@pytest.mark.parametrize("name", ["minicpm", "minicpm_ef"])
def test_data_split_later_steps(group_run, name):
    """The dense scenarios' second and third steps on the (4, 1) mesh:
    the loss within ``LOSS_REL`` and the grad norm within ``GNORM_REL``
    (measured 7.9e-5 and 3.3e-3 at most).  Arctic is held at its first
    step here: after a step, the first step's sign flips move its
    router's logits and swap top-2 choices (on a 2 x 2 data split its
    grad norm 0.28 apart at the second step, its loss 2.4e-3 at the
    third)."""
    one = group_run["one"][name]["metrics"]
    got = group_run["ranks"][0]["4x1"][name]["metrics"]
    for (l1, g1), (l2, g2) in list(zip(one, got))[1:]:
        assert abs(l2 - l1) <= LOSS_REL * l1, (l1, l2)
        assert abs(g2 - g1) <= GNORM_REL * g1, (g1, g2)


def test_compression_codes_and_scales_are_global(group_run):
    """The one-process gradients and residuals placed on the 2 x 2 mesh
    and compressed there: the codes and residuals reassemble to the
    one-process ones and every rank holds the one-process scales."""
    qs, scales, res = group_run["one"]["compress"]
    for key, tree in (("q", qs), ("res", res)):
        for got, want in zip(_assemble(group_run, "2x2", "compress", key,
                                       tree), TR.leaves(tree)):
            assert torch.equal(got, want)
    for o in group_run["ranks"]:
        assert all(torch.equal(a, b) for a, b in
                   zip(o["2x2"]["compress"]["scale"], TR.leaves(scales)))


def test_uneven_labels_give_the_global_loss(group_run):
    """The loss of a batch whose valid labels fall 32 : 32 : 3 : 3 over
    the (4, 1) mesh's data ranks is the one-process loss; a mean of the
    halves' means is not."""
    one = group_run["one"]["uneven"]
    for o in group_run["ranks"]:
        assert abs(o["uneven"] - one) <= XENT_REL * one, (o["uneven"], one)
    mean_of_means = sum(group_run["one"]["halves"]) / 2
    assert abs(mean_of_means - one) > 100 * XENT_REL * one


def test_against_the_reference_model_parallel_run(group_run):
    """The reference's ``train`` at ``--model-parallel 2`` on four forced
    host devices and the port's on the 2 x 2 group, from the same
    parameters on the same data."""
    ref = group_run["reference"]
    got = group_run["ranks"][0]["jax_run_losses"]
    assert len(ref) == len(got) == STEPS
    for a, b in zip(ref, got):
        assert abs(a - b) <= LOSS_REL * a, (ref, got)


# ---------------------------------------------------------------------------
# the CLI through torchrun: elastic restore both ways, crash and resume
# ---------------------------------------------------------------------------


CLI = ["--device", "cpu", "--arch", "minicpm-2b", "--reduced", "--steps",
       "8", "--global-batch", "4", "--seq", "64", "--ckpt-every", "4"]


def _cli(ckpt: Path, ranks: int, *extra):
    launch = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(ranks)] if ranks > 1
              else [sys.executable])
    args = ["--model-parallel", str(MP)] if ranks > 1 else []
    return subprocess.run(
        [*launch, "-m", "repro_torch.launch.train", *CLI, *args,
         "--ckpt-dir", str(ckpt), *extra], env=_env(),
        capture_output=True, text=True, timeout=600)


def _final(p) -> float:
    line = p.stdout.strip().splitlines()[-1]
    assert line.startswith("final loss: "), p.stdout[-2000:]
    return float(line.split()[2])


def _crcs(ckpt: Path) -> dict:
    index = json.loads((ckpt / "step_00000008" / "index.json").read_text())
    return {n: v["crc32"] for n, v in index["leaves"].items()}


def test_elastic_restore_and_crash_under_the_mesh(tmp_path):
    """Wave one: a clean 2 x 2 run, a 2 x 2 run crashing at step 6, a
    clean one-process run and a one-process run crashing at step 4 (after
    its step-4 checkpoint).  Wave two: the one-process crash resumed on
    the 2 x 2 mesh, the 2 x 2 crash resumed on it, and the clean 2 x 2
    run's step-4 checkpoint resumed in one process."""
    with ThreadPoolExecutor(4) as pool:
        runs = {name: pool.submit(_cli, tmp_path / name, ranks, *extra)
                for name, ranks, extra in (
                    ("mesh", WORLD, ()),
                    ("mesh_crash", WORLD, ("--fail-at-step", "6")),
                    ("one", 1, ()),
                    ("one_crash", 1, ("--fail-at-step", "4")))}
        runs = {k: f.result() for k, f in runs.items()}
    for name in ("mesh", "one"):
        assert runs[name].returncode == 0, runs[name].stderr[-3000:]
    assert runs["one_crash"].returncode == 17
    assert runs["mesh_crash"].returncode != 0
    for name, step in (("one_crash", 4), ("mesh_crash", 6)):
        assert f"[fault] injected failure at step {step}" in \
            runs[name].stdout, runs[name].stdout[-2000:]
    (tmp_path / "mesh_to_one").mkdir()
    shutil.copytree(tmp_path / "mesh" / "step_00000004",
                    tmp_path / "mesh_to_one" / "step_00000004")
    with ThreadPoolExecutor(3) as pool:
        resumed = {
            "one_to_mesh": pool.submit(_cli, tmp_path / "one_crash", WORLD),
            "mesh_crash": pool.submit(_cli, tmp_path / "mesh_crash", WORLD),
            "mesh_to_one": pool.submit(_cli, tmp_path / "mesh_to_one", 1)}
        resumed = {k: f.result() for k, f in resumed.items()}
    for name, p in resumed.items():
        assert p.returncode == 0, (name, p.stderr[-3000:])
        assert "[restore] resumed from step 4" in p.stdout, name
    clean = _final(runs["one"])
    for name in ("one_to_mesh", "mesh_to_one"):
        assert abs(_final(resumed[name]) - clean) <= LOSS_REL * clean
    assert abs(_final(runs["mesh"]) - clean) <= LOSS_REL * clean
    assert _final(resumed["mesh_crash"]) == _final(runs["mesh"])
    assert _crcs(tmp_path / "mesh_crash") == _crcs(tmp_path / "mesh")


def test_local_mesh_without_a_group():
    """One process without a group is a world of one: ``--model-parallel
    2`` does not divide it (the reference's assertion on one device), and
    no mesh is built without a group."""
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="model-parallel 2"):
        make_local_mesh(2, "cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_local_mesh(1, "cpu")


# ---------------------------------------------------------------------------
# a one-rank group
# ---------------------------------------------------------------------------


@pytest.fixture
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield SH.ShardingPolicy(mesh=make_local_mesh(1, "cpu"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_one_rank_policy_step_is_the_one_device_step(one_rank_group, name):
    arch, compress = SCENARIOS[name]
    cfg = _cfg(arch)
    sharded = _run(one_rank_group.place(_init(arch)), cfg, compress,
                   one_rank_group)
    plain = _run(_init(arch), cfg, compress)
    assert sharded["metrics"] == plain["metrics"]
    for key in ("params", "m", "v"):
        for a, b in zip(sharded[key], plain[key]):
            assert torch.equal(a, b), key


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(Path(sys.argv[2]), int(sys.argv[3]))

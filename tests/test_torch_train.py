"""The port's training path (``repro_torch.models.lm`` loss and training
forward, ``repro_torch.launch.train``) against the reference's on the CPU.

* ``chunked_xent`` over several chunks with ignored labels: the loss within
  ``XENT_REL`` of ``jax.jit`` of the reference's, its gradients within
  ``GRAD_REL`` of the leaf's largest magnitude.
* ``train_loss`` and its gradients against ``jax.jit(jax.value_and_grad(
  lm.train_loss))`` from the same (carried) parameters at two layers of the
  reduced minicpm-2b (dense, tied), arctic-480b (MoE with its dense
  residual), mamba2-1.3b (SSM) and seamless-m4t-large-v2 (encoder and
  cross-attention), one compile each: the loss within ``LOSS_REL``, each
  gradient leaf within ``GRAD_REL`` of its largest magnitude.  Both sides
  compute in bf16 with f32 sums in their own orders, so a gradient moves
  by bf16 steps (measured: at most 2.4e-2 of a leaf's largest magnitude).
  Two kinds of leaf are ill-conditioned at init, and the test says how it
  holds them.  Arctic's router, drawn at init, spreads each token's
  probabilities near 1/8, so bf16-level differences swap top-2 choices: a
  1e-3 relative perturbation of the weights moves the port's own gradients
  by 10–50%.  The test scales the router by ``ROUTER_SCALE`` on both sides,
  so every route is decisive (measured then: loss 2.4e-4 apart, gradients
  within 1.7e-2).  Mamba's per-head ``dt_bias`` gradient is a sum over
  every position and head dimension that cancels: three such 1e-3
  perturbations move the port's own gradient by 0.30–0.32 of its largest
  magnitude in layer 0 and 0.04–0.07 in layer 1, as far as it is from the
  reference's (0.30 and 0.067), so each layer's ``dt_bias`` is held to
  its own bound in ``DT_BIAS_REL`` (a missing softplus derivative would
  scale it by the sigmoid of the biased input, 1e-3–0.1 at init, far past
  either).  The other per-head sums, ``a_log`` and ``d_skip``, are within
  ``GRAD_REL`` (measured 7.1e-3 and 7.0e-3; 1.2e-2–2.9e-2 under the
  perturbations).
* Every other arch of ``repro_torch.configs.ARCHS``: a finite loss and
  finite, non-zero gradients from the port alone.
* One ``build_step`` step with compression off and on against the
  reference's under ``jax.jit``: loss, grad norm and lr, and the
  parameters after the step (AdamW's first step moves each element by
  about ``lr``, so an element whose gradient is within the gradients'
  noise of zero may step the other way: every element within ``2·lr`` and
  all but ``FLIP_FRAC`` of them within ``1e-3·lr``).
* The reference's behaviour tests on the port: the loss falls, minicpm
  trains with WSD, compressed gradients learn, and a crash mid-run resumes
  from its checkpoint to the clean run's final loss
  (``tests/test_distributed.py``'s test, through ``python -m
  repro_torch.launch.train --device cpu``); the refusals.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_platform_name", "cpu")

from repro.configs import get_reduced as jget_reduced
from repro.launch import train as JTRAIN
from repro.models import lm as JLM
from repro.optim import AdamWConfig as JAdamW
from repro.optim import make_schedule as jmake_schedule
from repro.optim.compression import init_error_state as jinit_error

from repro_torch import tree as TR
from repro_torch.configs import ARCHS, get_reduced
from repro_torch.launch import train as TTRAIN
from repro_torch.models import lm as TLM
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig as TAdamW
from repro_torch.optim import make_schedule as tmake_schedule

# One PyTorch thread a process: the tier-1 run puts six pytest workers on
# the machine's cores, where PyTorch's default of an OpenMP thread per core
# makes each worker's ops wait on the others' (tens of times slower).
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
XENT_REL = 1e-3
LOSS_REL = 1e-3
GRAD_REL = 3e-2
ROUTER_SCALE = 30.0
DT_BIAS_REL = (0.35, 0.1)       # Mamba's layer 0, layer 1
FLIP_FRAC = 0.02
FAMILIES = ("minicpm-2b", "arctic-480b", "mamba2-1.3b",
            "seamless-m4t-large-v2")
SEQ = 32


def _t(a):
    return torch.from_numpy(np.array(a))


def _configs(arch: str, layers: int = 2):
    return (dataclasses.replace(jget_reduced(arch), num_layers=layers),
            dataclasses.replace(get_reduced(arch), num_layers=layers))


def _batch(cfg, seed: int, b: int = 2, s: int = SEQ) -> dict:
    """Tokens, next-token labels (a few ignored), and the frontend's input:
    patch rows (their label positions ignored) or frames."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out = {"tokens": tok[:, :-1], "labels": tok[:, 1:].copy()}
    out["labels"][:, ::7] = -1
    if cfg.frontend == "patch":
        out["patches"] = rng.normal(
            size=(b, cfg.num_patches, cfg.d_model)).astype(np.float32)
        out["labels"] = np.concatenate(
            [np.full((b, cfg.num_patches), -1, np.int32), out["labels"]], 1)
    elif cfg.frontend == "frames" or cfg.encoder_layers:
        out["frames"] = rng.normal(size=(b, s // cfg.frame_ratio,
                                         cfg.d_model)).astype(np.float32)
    return out


def _leaf_rel(ref, got) -> float:
    ref, got = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    return float(np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-30))


def _trainable(tree):
    for leaf in TR.leaves(tree):
        leaf.requires_grad_(True)
    return tree


def _port_grads(params, batch, cfg):
    flat = TR.leaves(params)
    loss = TLM.train_loss(params, batch, cfg)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return float(loss), TR.unflatten_like(params, list(grads))


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


def test_chunked_xent_matches_reference():
    """Three chunks of 16 positions, every seventh label ignored, a tied
    head: the loss and its gradients with respect to the hidden states and
    the head."""
    rng = np.random.default_rng(0)
    b, s, d, v = 2, 48, 32, 96
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    head = (rng.normal(size=(d, v)) * 0.2).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    labels[:, ::7] = -1
    jx = jnp.asarray(x, jnp.bfloat16)

    def jloss(a, h):
        return JLM.chunked_xent(a, h, jnp.asarray(labels), chunk=16)
    jl, (jgx, jgh) = jax.jit(jax.value_and_grad(jloss, (0, 1)))(
        jx, jnp.asarray(head))
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(torch.bfloat16)
    tx.requires_grad_(True)
    th = _t(head).requires_grad_(True)
    tl = TLM.chunked_xent(tx, th, _t(labels), chunk=16)
    tgx, tgh = torch.autograd.grad(tl, (tx, th))
    assert abs(float(tl) - float(jl)) <= XENT_REL * abs(float(jl))
    assert _leaf_rel(jgx.astype(jnp.float32), tgx.float()) <= GRAD_REL
    assert _leaf_rel(jgh, tgh) <= GRAD_REL
    with pytest.raises(AssertionError):
        TLM.chunked_xent(tx, th, _t(labels), chunk=20)


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """The reference's loss and gradients under one compile, from its
    ``init_params(PRNGKey(0))``, and the port's from the same numbers."""
    arch = request.param
    jcfg, tcfg = _configs(arch)
    jparams = JLM.init_params(jax.random.PRNGKey(0), jcfg)
    if tcfg.num_experts:
        jparams["period"] = tuple(dict(p, gate_w=p["gate_w"] * ROUTER_SCALE)
                                  for p in jparams["period"])
    batch = _batch(tcfg, seed=1)
    jl, jg = jax.jit(lambda p, bt: jax.value_and_grad(JLM.train_loss)(
        p, bt, jcfg))(jparams, jax.tree.map(jnp.asarray, batch))
    tparams = _trainable(TLM.from_jax_params(
        jax.tree.map(np.asarray, jparams), tcfg))
    tl, tg = _port_grads(tparams, {k: _t(v) for k, v in batch.items()},
                         tcfg)
    ref = TLM.from_jax_params(jax.tree.map(np.asarray, jg), tcfg)
    return dict(arch=arch, jloss=float(jl), tloss=tl, ref=ref, got=tg)


def test_train_loss_matches_reference(family):
    assert np.isfinite(family["tloss"])
    assert abs(family["tloss"] - family["jloss"]) <= \
        LOSS_REL * abs(family["jloss"])


def test_gradients_match_reference(family):
    """Every leaf: the same shape, and within ``GRAD_REL`` of its largest
    magnitude (Mamba's ``dt_bias`` within its layer's ``DT_BIAS_REL``; an
    expert that keeps no token gets zeros on both sides)."""
    ref = TR.flatten_with_paths(family["ref"])
    got = TR.flatten_with_paths(family["got"])
    assert [p for p, _ in ref] == [p for p, _ in got]
    worst = {}
    for (path, r), (_, g) in zip(ref, got):
        assert g is not None, path
        assert tuple(g.shape) == tuple(r.shape), path
        assert bool(torch.isfinite(g).all()), path
        rel = _leaf_rel(r.float(), g.float())
        if path[-1] == "dt_bias":
            assert rel <= DT_BIAS_REL[path[1]], (path, rel)
        else:
            worst[TR.path_name(path)] = rel
    assert max(worst.values()) <= GRAD_REL, sorted(
        worst.items(), key=lambda kv: -kv[1])[:5]


@pytest.mark.parametrize("arch", sorted(
    set(a.replace("_", "-") for a in ARCHS) -
    {"minicpm-2b", "arctic-480b", "mamba2-1-3b", "seamless-m4t-large-v2"}))
def test_every_other_arch_trains_finite(arch):
    """Reduced, two layers (Jamba's eight-layer period stays whole): the
    port's loss and every gradient finite, and each weight's gradient not
    all zero."""
    cfg = get_reduced(arch)
    if cfg.family != "hybrid":
        cfg = dataclasses.replace(cfg, num_layers=2)
    params = _trainable(TLM.init_params(cfg, 0, device="cpu"))
    loss, grads = _port_grads(params, {k: _t(v) for k, v in _batch(
        cfg, seed=2).items()}, cfg)
    assert np.isfinite(loss) and loss > 0
    for path, g in TR.flatten_with_paths(grads):
        assert g is not None and bool(torch.isfinite(g).all()), path
    for p in grads["layers"]:
        for k in ("wq", "in_proj", "wi_gate", "we_gate"):
            if k in p:
                assert float(p[k].abs().max()) > 0, (arch, k)


# ---------------------------------------------------------------------------
# one step of the trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compress", [False, True])
def test_build_step_matches_reference(compress):
    """Reduced minicpm-2b at two layers, WSD at its first step: the
    reference's ``build_step`` under ``jax.jit`` and the port's from the
    same carried parameters, optimizer and error-feedback state."""
    jcfg, tcfg = _configs("minicpm-2b")
    lr, warmup, steps = 3e-3, 4, 20
    jopt = JAdamW(lr=lr, schedule=jmake_schedule(jcfg.schedule, lr, warmup,
                                                 steps))
    topt = TAdamW(lr=lr, schedule=tmake_schedule(tcfg.schedule, lr, warmup,
                                                 steps))
    jparams = JLM.init_params(jax.random.PRNGKey(3), jcfg)
    from repro.optim import adamw_init
    jstate = adamw_init(jparams, jopt)
    jerr = jinit_error(jparams) if compress else {"_": jnp.zeros(())}
    host = jax.tree.map(np.asarray, (jparams, jstate, jerr))
    batch = _batch(tcfg, seed=4)
    step = jax.jit(JTRAIN.build_step(jcfg, None, jopt, compress))
    jp, js, je, jm = step(jparams, jstate, jerr,
                          jax.tree.map(jnp.asarray, batch))

    tparams = _trainable(TLM.from_jax_params(host[0], tcfg))
    tstate, terr = TLM.from_jax_train_state(host[1], host[2], tcfg)
    tp, ts, te, tm = TTRAIN.build_step(tcfg, None, topt, compress)(
        tparams, tstate, terr, {k: _t(v) for k, v in batch.items()})

    assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
        LOSS_REL * float(jm["loss"])
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
        GRAD_REL * float(jm["grad_norm"])
    assert float(tm["lr"]) == float(jm["lr"]) > 0
    assert int(ts["step"]) == int(js["step"]) == 1
    step_lr = float(jm["lr"])
    ref = TLM.from_jax_params(jax.tree.map(np.asarray, jp), tcfg)
    far = total = 0
    for (path, r), (_, g) in zip(TR.flatten_with_paths(ref),
                                 TR.flatten_with_paths(tp)):
        d = (g.detach().float() - r.float()).abs()
        assert float(d.max()) <= 2 * step_lr * (1 + 1e-3), path
        far += int((d > 1e-3 * step_lr).sum())
        total += d.numel()
    assert far <= FLIP_FRAC * total, far / total
    if compress:
        ref_err = TLM.from_jax_params(jax.tree.map(np.asarray, je), tcfg)
        for (path, r), (_, g) in zip(TR.flatten_with_paths(ref_err),
                                     TR.flatten_with_paths(te)):
            assert g.dtype == torch.float32 and g.shape == r.shape, path
            assert float(g.abs().max()) <= float(r.abs().max()) * 1.5 + \
                1e-12, path


def test_from_jax_train_state_carries_the_optimizer():
    jcfg, tcfg = _configs("arctic-480b")
    jparams = JLM.init_params(jax.random.PRNGKey(0), jcfg)
    from repro.optim import adamw_init
    js = adamw_init(jparams, JAdamW())
    js = dict(js, step=jnp.asarray(5, jnp.int32),
              m=jax.tree.map(lambda a: a + 1.0, js["m"]))
    host = jax.tree.map(np.asarray, (js, jinit_error(jparams)))
    opt, err = TLM.from_jax_train_state(host[0], host[1], tcfg)
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 5
    shapes = [tuple(t.shape) for t in TR.leaves(
        TLM.from_jax_params(jax.tree.map(np.asarray, jparams), tcfg))]
    for tree in (opt["m"], opt["v"], err):
        assert [tuple(t.shape) for t in TR.leaves(tree)] == shapes
    assert all(bool((t == 1.0).all()) for t in TR.leaves(opt["m"]))
    placeholder = TLM.from_jax_train_state(host[0], {"_": np.zeros(())},
                                           tcfg)[1]
    assert set(placeholder) == {"_"}


# ---------------------------------------------------------------------------
# the reference's behaviour tests, on the port
# ---------------------------------------------------------------------------

SYS_CFG = ModelConfig(name="sys-test", family="dense", num_layers=2,
                      d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                      vocab_size=256, tie_embeddings=True)


def test_loss_decreases():
    """``tests/test_system.py``'s config and run: 100 steps of 8 × 64."""
    out = TTRAIN.train(SYS_CFG, TTRAIN.TrainConfig(
        steps=100, global_batch=8, seq=64, lr=3e-3, warmup=10),
        ckpt_dir=None, verbose=False, device="cpu")
    losses = out["losses"]
    assert len(losses) == 100 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.9, \
        f"no learning: {losses[0]:.3f} -> {losses[-1]:.3f}"


def test_compressed_grads_still_learn():
    out = TTRAIN.train(SYS_CFG, TTRAIN.TrainConfig(
        steps=60, global_batch=8, seq=64, lr=3e-3, warmup=10,
        compress_grads=True), ckpt_dir=None, verbose=False, device="cpu")
    assert out["losses"][-1] < out["losses"][0]


def test_minicpm_trains_with_wsd(monkeypatch):
    """The trainer takes its schedule from the config: minicpm-2b's is WSD
    (the plateau at the peak after warmup)."""
    cfg = get_reduced("minicpm-2b")
    assert cfg.schedule == "wsd" == jget_reduced("minicpm-2b").schedule
    seen = []
    real = TTRAIN.make_schedule

    def spy(kind, *a):
        seen.append(kind)
        return real(kind, *a)
    monkeypatch.setattr(TTRAIN, "make_schedule", spy)
    out = TTRAIN.train(dataclasses.replace(cfg, num_layers=1),
                       TTRAIN.TrainConfig(steps=3, global_batch=2, seq=16,
                                          warmup=1), verbose=False,
                       device="cpu")
    assert seen == ["wsd"] and len(out["losses"]) == 3


def _cli(args, tmp_path, name):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "minicpm-2b", "--reduced", "--steps", "12",
         "--global-batch", "2", "--seq", "64", "--ckpt-every", "4",
         "--ckpt-dir", str(tmp_path / name), *args],
        env=env, capture_output=True, text=True, timeout=300)


def test_crash_and_restart_resumes(tmp_path):
    """``tests/test_distributed.py``'s test on the port: a hard crash at
    step 6 (exit 17), a restart that resumes from the step-4 checkpoint, and
    the clean run's final loss, printed alike."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(2) as pool:
        crash = pool.submit(_cli, ["--fail-at-step", "6"], tmp_path, "crash")
        clean = pool.submit(_cli, [], tmp_path, "clean")
        p, p3 = crash.result(), clean.result()
    assert p.returncode == 17, p.stderr[-800:]
    assert "[fault] injected failure at step 6" in p.stdout
    p2 = _cli([], tmp_path, "crash")
    assert p2.returncode == 0, p2.stderr[-800:]
    assert "[restore] resumed from step 4" in p2.stdout
    assert p3.returncode == 0, p3.stderr[-800:]
    final_resumed = p2.stdout.strip().splitlines()[-1]
    final_clean = p3.stdout.strip().splitlines()[-1]
    assert final_resumed.startswith("final loss: ")
    assert final_resumed.split()[2] == final_clean.split()[2], \
        (final_resumed, final_clean)


def test_refusals():
    """In one process without a group, ``--model-parallel 2`` raises, as
    the reference's mesh assertion does on one device; without ``--device
    cpu`` the trainer runs on ``cuda`` and raises with no card; a
    sequence-sharded policy is refused (only the dry run sets it)."""
    from repro.launch.mesh import make_local_mesh as jmake_local_mesh
    from repro_torch.sharding import ShardingPolicy
    with pytest.raises(AssertionError):
        jmake_local_mesh(2)
    tc = TTRAIN.TrainConfig(steps=1, global_batch=2, seq=16,
                            model_parallel=2)
    with pytest.raises(ValueError, match="model-parallel 2"):
        TTRAIN.train(SYS_CFG, tc, device="cpu")
    with pytest.raises(ValueError, match="model-parallel 2"):
        TTRAIN.main(["--reduced", "--device", "cpu", "--model-parallel",
                     "2", "--steps", "1"])
    with pytest.raises(NotImplementedError, match="seq_sharded"):
        TTRAIN.build_step(SYS_CFG, ShardingPolicy(mesh=None,
                                                  seq_sharded=True),
                          TAdamW(), False)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs none")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TTRAIN.train(SYS_CFG, TTRAIN.TrainConfig(steps=1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TTRAIN.main(["--reduced", "--steps", "1"])


def test_cli_takes_every_flag_of_the_reference():
    """The reference's flags, each parsed (``--device`` added)."""
    import inspect
    import re
    flags = sorted(set(re.findall(r'"(--[a-z-]+)"',
                                  inspect.getsource(JTRAIN.main))))
    seen = {}

    def fake_train(cfg, tc, ckpt_dir=None, verbose=True, device=None):
        seen.update(cfg=cfg, tc=tc, ckpt_dir=ckpt_dir, device=device)
        return {"losses": [2.0, 1.0]}
    real = TTRAIN.train
    TTRAIN.train = fake_train
    try:
        TTRAIN.main(["--arch", "minicpm-2b", "--reduced", "--steps", "7",
                     "--global-batch", "4", "--seq", "32", "--lr", "1e-3",
                     "--ckpt-dir", "/nonexistent", "--ckpt-every", "3",
                     "--model-parallel", "1", "--compress-grads",
                     "--fail-at-step", "5", "--device", "cpu"])
    finally:
        TTRAIN.train = real
    assert flags == sorted(["--arch", "--reduced", "--steps",
                            "--global-batch", "--seq", "--lr", "--ckpt-dir",
                            "--ckpt-every", "--model-parallel",
                            "--compress-grads", "--fail-at-step"])
    tc = seen["tc"]
    assert (tc.steps, tc.global_batch, tc.seq, tc.lr, tc.ckpt_every,
            tc.model_parallel, tc.compress_grads, tc.fail_at_step) == \
        (7, 4, 32, 1e-3, 3, 1, True, 5)
    assert seen["ckpt_dir"] == "/nonexistent" and seen["device"] == "cpu"
    assert seen["cfg"] == get_reduced("minicpm-2b")
    assert dataclasses.asdict(TTRAIN.TrainConfig()) == \
        dataclasses.asdict(JTRAIN.TrainConfig())

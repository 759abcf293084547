"""The port's optimizer (``repro_torch.optim``) against the reference's
(``repro.optim``) under ``jax.jit`` on the CPU.

* Schedules: every step ``0..total`` within ``SCHED_ULP`` f32 ulp of the
  compiled reference (the port folds the constants as XLA does; XLA's own
  ``cos`` / ``exp`` and its fused multiply-adds move a value by up to 3
  ulp, measured).
* AdamW: three steps of a small tree of f32 and bf16 leaves, clip on and
  off, from the same state: each leaf of the parameters and moments within
  ``ADAM_ULP`` f32 ulp of its largest magnitude (the compiled update
  contracts multiply-adds into FMAs, and its sum of squares for the global
  norm runs in another order: the norm, and with it the clip's scale,
  moves by an ulp — measured 1 ulp of the leaf), a bf16 parameter within
  one bf16 step; the step count exact, the grad norm within 2 ulp, the lr
  within ``SCHED_ULP``.
* Compression: codes and scales exact; the reference's error-feedback
  property over 50 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_platform_name", "cpu")

from repro.optim import adamw as JA
from repro.optim import compression as JC
from repro.optim import schedules as JS

from repro_torch import optim as TO
from repro_torch.optim import adamw as TA
from repro_torch.optim import compression as TC
from repro_torch.optim import schedules as TSC

# One PyTorch thread a process: the tier-1 run puts six pytest workers on
# the machine's cores, where PyTorch's default of an OpenMP thread per core
# makes each worker's ops wait on the others' (tens of times slower).
torch.set_num_threads(1)

SCHED_ULP = 4
ADAM_ULP = 2


def _ulp(a, b) -> int:
    """Largest distance in f32 ulp (equal signs assumed near zero)."""
    a = np.asarray(a, np.float32).reshape(-1).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).reshape(-1).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def _leaf_close(a, b, ulps: int) -> bool:
    """``|a − b| ≤ ulps`` f32 ulp at the largest magnitude of ``a``."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return bool(np.abs(a - b).max() <=
                ulps * 2.0 ** -23 * max(float(np.abs(a).max()), 1e-30))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["wsd", "cosine"])
@pytest.mark.parametrize("peak,warmup,total", [
    (3e-3, 40, 400), (3e-4, 20, 100), (1e-3, 0, 7), (3e-4, 10, 12),
    (3e-4, 20, 12)])
def test_schedule_matches_compiled_reference(kind, peak, warmup, total):
    steps = np.arange(total + 1, dtype=np.int32)
    ref = np.asarray(jax.jit(jax.vmap(JS.make_schedule(
        kind, peak, warmup, total)))(jnp.asarray(steps)))
    fn = TSC.make_schedule(kind, peak, warmup, total)
    got = np.array([float(fn(torch.tensor(s))) for s in steps], np.float32)
    assert _ulp(ref, got) <= SCHED_ULP
    # the warmup ramp and the stable plateau are exact
    flat = steps < min(warmup, int(total * 0.9))
    np.testing.assert_array_equal(ref[flat], got[flat])


def test_wsd_shape():
    """The reference's test on the port: warmup from 0, the plateau at the
    peak, the decay to ``min_ratio`` 0.01 at the end."""
    fn = TSC.make_schedule("wsd", 1e-3, 10, 100)
    assert float(fn(0)) == 0.0
    assert float(fn(50)) == pytest.approx(1e-3)         # the plateau
    assert float(fn(100)) == pytest.approx(1e-5)        # min_ratio 0.01


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _tree(rng, dtype_b):
    return {"a": rng.normal(size=(8, 16)).astype(np.float32),
            "layers": [{"w": rng.normal(size=(4, 5)).astype(np.float32),
                        "b": rng.normal(size=(33,)).astype(np.float32)}],
            "z": np.float32(rng.normal(size=())) * np.ones((3,), np.float32)}


BF16 = ("layers", 0, "b")


def _leaves_j(tree):
    return jax.tree.leaves(tree)


def _to_jax(tree):
    out = jax.tree.map(jnp.asarray, tree)
    out["layers"][0]["b"] = out["layers"][0]["b"].astype(jnp.bfloat16)
    return out


def _to_torch(tree):
    out = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)
    out["layers"][0]["b"] = out["layers"][0]["b"].to(torch.bfloat16)
    return out


@pytest.mark.parametrize("clip", [1.0, 1e9])
def test_adamw_three_steps_match_compiled_reference(clip):
    """Same parameters, grads and schedule on both sides; the reference's
    step under ``jax.jit``, the port's in place.  Grads are drawn large so
    that ``clip`` 1.0 rescales them and 1e9 does not."""
    rng = np.random.default_rng(0)
    p0 = _tree(rng, None)
    sched = dict(kind="wsd", peak_lr=1e-2, warmup=2, total=3)
    jcfg = JA.AdamWConfig(grad_clip=clip, schedule=JS.make_schedule(**sched))
    tcfg = TA.AdamWConfig(grad_clip=clip, schedule=TSC.make_schedule(**sched))
    jp, tp = _to_jax(p0), _to_torch(p0)
    js, ts = JA.adamw_init(jp, jcfg), TA.adamw_init(tp, tcfg)
    jstep = jax.jit(lambda g, s, p: JA.adamw_update(g, s, p, jcfg))
    for i in range(3):
        g = jax.tree.map(lambda a: (rng.normal(size=np.shape(a)) * 3.0
                                    ).astype(np.float32), p0)
        jp, js, jm = jstep(_to_jax(g), js, jp)
        tp, ts, tm = TA.adamw_update(_to_torch(g), ts, tp, tcfg)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        assert _ulp(jm["grad_norm"], _np(tm["grad_norm"])) <= 2
        assert _ulp(jm["lr"], _np(tm["lr"])) <= SCHED_ULP
        if clip == 1.0:
            assert float(jm["grad_norm"]) > 1.0
        for name, jt, tt in (("p", jp, tp), ("m", js["m"], ts["m"]),
                             ("v", js["v"], ts["v"])):
            for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(
                    jt)[0], jax.tree.leaves(jax.tree.map(
                        lambda x: x, tt, is_leaf=lambda x: isinstance(
                            x, torch.Tensor)))):
                keys = tuple(getattr(k, "key", getattr(k, "idx", k))
                             for k in path)
                if name == "p" and keys == BF16:
                    assert b.dtype == torch.bfloat16
                    step = np.abs(_np(a)) * 2.0 ** -7 + 1e-30
                    assert (np.abs(_np(a) - _np(b)) <= step).all(), keys
                else:
                    assert b.dtype == torch.float32
                    assert _leaf_close(_np(a), _np(b), ADAM_ULP), (name,
                                                                   keys)


def test_global_norm_sums_leaves_in_order():
    rng = np.random.default_rng(1)
    t = _tree(rng, None)
    ref = float(jax.jit(JA.global_norm)(_to_jax(t)))
    assert _ulp(ref, float(TA.global_norm(_to_torch(t)))) <= 2


def test_exports_are_the_references():
    import repro.optim as JO
    names = [n for n in dir(JO) if not n.startswith("_")]
    for n in ("AdamWConfig", "adamw_init", "adamw_update", "make_schedule",
              "compress_gradients", "decompress_gradients",
              "error_feedback_update"):
        assert n in names and hasattr(TO, n)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [1.0, 1e-3, 0.0])
def test_compression_codes_and_scales_exact(scale):
    """Codes (round half to even, ±127) and the f32 scale ``absmax ·
    f32(1/127)`` bit-equal to the compiled reference's, with an error
    state carried in; the zero tree takes the 1e-12 floor."""
    rng = np.random.default_rng(2)
    g = {"a": (rng.normal(size=(64, 33)) * scale).astype(np.float32),
         "b": [(rng.standard_t(2, size=(257,)) * scale).astype(np.float32)]}
    e = {"a": (rng.normal(size=(64, 33)) * 1e-3 * scale).astype(np.float32),
         "b": [np.zeros((257,), np.float32)]}
    jq, js, je = jax.jit(JC.compress_gradients)(
        jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, e))
    tq, ts, te = TC.compress_gradients(
        jax.tree.map(lambda a: torch.from_numpy(a), g),
        jax.tree.map(lambda a: torch.from_numpy(a), e))
    for a, b in zip(jax.tree.leaves(jq), jax.tree.leaves(
            jax.tree.map(lambda x: x, tq, is_leaf=torch.is_tensor))):
        assert b.dtype == torch.int8
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(jax.tree.leaves(js), jax.tree.leaves(
            jax.tree.map(lambda x: x, ts, is_leaf=torch.is_tensor))):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()
    for a, b, sc in zip(jax.tree.leaves(je), jax.tree.leaves(
            jax.tree.map(lambda x: x, te, is_leaf=torch.is_tensor)),
            jax.tree.leaves(js)):
        # the residual ``corrected − q·scale`` is one fused multiply-add in
        # the compiled reference: within an ulp of the leaf's largest
        # magnitude, ``127·scale``
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0,
                                   atol=127 * float(sc) * 2.0 ** -23)
    deq = TC.decompress_gradients(tq, ts)
    jd = JC.decompress_gradients(jq, js)
    np.testing.assert_array_equal(np.asarray(jd["a"]), deq["a"].numpy())


def test_error_feedback_reduces_bias():
    """The reference's property (``tests/test_distributed.py``) on the
    port: over 50 steps of the same gradient, the error-fed sum is no
    further from the true sum than plain int8 rounding, and within 1% of
    it."""
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))}
    acc_plain = np.zeros(256)
    acc_ef = np.zeros(256)
    err_state = TC.init_error_state(g)
    for _ in range(50):
        q, scales, _ = TC.compress_gradients(g, TC.init_error_state(g))
        acc_plain += q["w"].numpy().astype(np.float32) * float(scales["w"])
        deq, err_state = TC.error_feedback_update(g, err_state)
        acc_ef += deq["w"].numpy()
    target = g["w"].numpy() * 50
    assert np.abs(acc_ef - target).max() <= \
        np.abs(acc_plain - target).max() + 1e-5
    assert np.abs(acc_ef - target).max() / np.abs(target).max() < 0.01

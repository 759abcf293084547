"""The port's paged serving engine against the JAX reference engine on the
CPU, on the prompts of ``test_unified_step.py`` (5 requests, 3 slots,
16-token chunks, staggered admission): both run the unified step with the
fused STaMP linears, the decode matmul and the paged attention kernel, on
the same weights (``from_jax_params``), and greedy decoding must give the
same tokens.  Plus the engine's host-side machinery on the port alone:
prefix caching with copy-on-write, preemption with swap, rejection.
"""

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_platform_name", "cpu")

# One PyTorch thread a process: the tier-1 run puts six pytest workers on
# the machine's cores, where PyTorch's default of an OpenMP thread per core
# makes each worker's ops wait on the others' (tens of times slower).
torch.set_num_threads(1)

from repro.core.stamp import StampConfig as JStampConfig
from repro.models import lm as JLM
from repro.models.config import ModelConfig as JModelConfig
from repro.serving import kvcache as JKV
from repro.serving.engine import PagedEngineConfig as JEngineConfig
from repro.serving.engine import PagedServingEngine as JEngine

from repro_torch.core.stamp import StampConfig as TStampConfig
from repro_torch.models import lm as TLM
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.serving import kvcache as TKV
from repro_torch.serving.engine import PagedEngineConfig as TEngineConfig
from repro_torch.serving.engine import PagedServingEngine as TEngine

DIMS = dict(name="unified-test", family="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128)
JCFG, TCFG = JModelConfig(**DIMS), TModelConfig(**DIMS)
PROMPT_LENS = (20, 40, 12, 33, 26)
MAX_NEW = (14, 10, 16, 8, 12)
ENGINE = dict(max_slots=3, prefill_chunk=16, max_seq=96, block_size=16)
LOGIT_TOL = 0.1


@pytest.fixture(scope="module")
def jparams():
    return JLM.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def tparams(jparams):
    return TLM.from_jax_params(jax.tree.map(np.asarray, jparams), TCFG)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(2)
    return [rng.integers(0, 128, n) for n in PROMPT_LENS]


def _serve(stamp_cls, kv_mod):
    return dict(stamp=stamp_cls(num_hi_tokens=8, execution="fused"),
                kv=kv_mod.KVCacheConfig(quantized=True, num_hi=16),
                fused_cache_attention=True)


def _drain(engine, prompts, max_new=MAX_NEW) -> dict:
    for p, m in zip(prompts, max_new):
        engine.submit(p, m)
    return {r.uid: np.asarray(r.out_tokens) for r in engine.run()}


@pytest.fixture(scope="module")
def runs(jparams, tparams, prompts):
    """The reference engine's greedy run, with every step's logits
    recorded; the port's free greedy run; and the port's run teacher-forced
    to the reference's tokens, with the port's own logits recorded.

    The schedule does not depend on token values (no EOS), so step ``i``
    of the forced run plans the same ragged batch as the reference's step
    ``i``: the forcing wrapper returns the reference's logits for the
    greedy pick and keeps the port's for the comparison."""
    jeng = JEngine(jparams, JCFG,
                   JLM.ServeConfig(**_serve(JStampConfig, JKV)),
                   JEngineConfig(**ENGINE))
    jsteps = []
    step = jeng._unified

    def record(*args):
        out = step(*args)
        jsteps.append(dict(pf_length=np.asarray(args[4]),
                           dec_pos=np.asarray(args[9]),
                           pf=np.asarray(out[0]), dec=np.asarray(out[1])))
        return out

    jeng._unified = record
    try:
        jout = _drain(jeng, prompts)
    finally:
        JLM.set_fused_cache_attention(False)
        JLM.set_fused_decode_matmul(False)

    def engine():
        return TEngine(tparams, TCFG, TLM.ServeConfig(**_serve(TStampConfig,
                                                               TKV)),
                       TEngineConfig(**ENGINE), device="cpu")

    free = engine()
    tout = _drain(free, prompts)
    tsteps = []
    real = TLM.paged_unified_step

    def forced(*args, **kw):
        pf, dec, pools = real(*args, **kw)
        ref = jsteps[len(tsteps)]
        tsteps.append(dict(pf=pf.numpy(), dec=dec.numpy()))
        return torch.tensor(ref["pf"]), torch.tensor(ref["dec"]), pools

    TLM.paged_unified_step = forced
    try:
        forced_out = _drain(engine(), prompts)
    finally:
        TLM.paged_unified_step = real
    return dict(jout=jout, tout=tout, forced=forced_out, jeng=jeng,
                teng=free, jsteps=jsteps, tsteps=tsteps)


def test_first_tokens_match_reference_engine(runs):
    """Free greedy runs: every request's first token (the prefill path's
    logits) is the reference's, and every request yields its full count.
    Later tokens follow a history that one near-tie can fork; the
    teacher-forced test below holds them."""
    jout, tout = runs["jout"], runs["tout"]
    assert set(jout) == set(tout) == {1, 2, 3, 4, 5}
    for uid in jout:
        assert len(tout[uid]) == len(jout[uid]) == MAX_NEW[uid - 1]
        assert tout[uid][0] == jout[uid][0], f"uid={uid}"


def test_teacher_forced_argmax_matches_reference_engine(runs):
    """Teacher-forced to the reference's tokens, the port's greedy pick is
    the reference's on every live row (non-dummy chunk rows, occupied
    decode slots) whose reference top-1/top-2 margin exceeds ``LOGIT_TOL
    = 0.1``, and the logits agree to 0.05 on average.  Most rows agree to
    a few bf16 steps; where one last-bit difference (XLA's and PyTorch's
    ``exp``) flips a 4-bit quantizer code, a row moves by up to a few
    tenths, so a closer race is a near-tie.  Most rows must be decisive."""
    for uid, toks in runs["jout"].items():       # the forcing took hold
        np.testing.assert_array_equal(runs["forced"][uid], toks)
    jsteps, tsteps = runs["jsteps"], runs["tsteps"]
    assert len(tsteps) == len(jsteps)
    decisive = live = 0
    dev = []
    for j, t in zip(jsteps, tsteps):
        rows = [(j["pf"][i], t["pf"][i]) for i in range(len(j["pf"]))
                if j["pf_length"][i] > 0]
        rows += [(j["dec"][s], t["dec"][s]) for s in range(len(j["dec"]))
                 if j["dec_pos"][s] > 0]
        for ref, got in rows:
            live += 1
            dev.append(np.abs(got - ref).mean())
            top2 = np.sort(ref)[-2:]
            if top2[1] - top2[0] > LOGIT_TOL:
                decisive += 1
                assert got.argmax() == ref.argmax()
    assert live >= sum(MAX_NEW) and decisive >= 0.75 * live
    assert float(np.mean(dev)) <= 0.05


def test_prefix_cache_mid_page_copy_on_write(tparams):
    """Two prompts sharing 40 tokens served one after the other with
    8-token chunks: the second adopts the cached pages, copies the page
    its match ends inside, and decodes exactly what a cache-off engine
    decodes (the reference's ``test_mid_page_divergence_cow_and_parity``,
    with the transform-free step so chunk boundaries cannot matter)."""
    serve = TLM.ServeConfig(kv=TKV.KVCacheConfig(quantized=True, num_hi=16),
                            fused_cache_attention=True)
    rng = np.random.default_rng(7)
    base = rng.integers(0, 128, 40)
    reqs = [np.concatenate([base, rng.integers(0, 128, 18)]),
            np.concatenate([base, rng.integers(0, 128, 14)])]
    out = {}
    for caching in (True, False):
        eng = TEngine(tparams, TCFG, serve,
                      TEngineConfig(**{**ENGINE, "max_slots": 1,
                                       "prefill_chunk": 8,
                                       "prefix_caching": caching}),
                      device="cpu")
        out[caching] = (_drain(eng, reqs, (5, 6)), dict(eng.stats))
    (on, st_on), (off, st_off) = out[True], out[False]
    for uid in (1, 2):
        np.testing.assert_array_equal(on[uid], off[uid])
    assert st_on["prefix_cache_hits"] >= 1 and st_on["cow_copies"] >= 1
    assert st_on["prefill_chunks"] < st_off["prefill_chunks"]


def test_preemption_swaps_and_resumes(tparams, prompts):
    """A lo pool too small for every admitted request preempts the latest
    arrival, swaps its pages to the host and resumes it; all requests
    still finish with their full token counts."""
    serve = TLM.ServeConfig(**_serve(TStampConfig, TKV))
    eng = TEngine(tparams, TCFG, serve,
                  TEngineConfig(**{**ENGINE, "max_slots": 5,
                                   "num_lo_blocks": 6}), device="cpu")
    out = _drain(eng, prompts)
    assert eng.stats["preemptions"] > 0 and eng.stats["resumes"] > 0
    assert eng.stats["swap_bytes"] > 0
    assert [len(out[uid]) for uid in sorted(out)] == list(MAX_NEW)


def test_submit_validates_and_rejects(tparams):
    serve = TLM.ServeConfig(**_serve(TStampConfig, TKV))
    eng = TEngine(tparams, TCFG, serve,
                  TEngineConfig(**{**ENGINE, "num_lo_blocks": 2}),
                  device="cpu")
    with pytest.raises(ValueError):
        eng.submit(np.zeros(0, np.int32))
    with pytest.raises(ValueError):
        eng.submit(np.array([0, 128]))
    uid = eng.submit(np.arange(60) % 128, 30)
    done = eng.run()
    assert [r.status for r in done] == ["rejected"] and done[0].uid == uid
    assert eng.stats["rejected"] == 1

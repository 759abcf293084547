"""The port's two-call step mode (``step_mode="two_call"``: one prefill
chunk through ``lm.paged_prefill_chunk``, then the decode slots through
``lm.paged_decode_step``) against the reference's two-call engine and the
port's own unified mode, on the workloads of ``test_unified_step.py``.

The contended workload (5 requests of one to three 16-token chunks on 3
slots over a lo pool of 4 pages, and on 5 slots over 6 pages: staggered
admission, preemption and resume mid-prefill) must give the reference's
two-call tokens and the port's unified tokens; so must the fused STaMP
case, with and without the decode attention kernel's plain version.  Then the pieces: the
``paged_decode_attention`` entry (K4 with ``n_pf = 0``) against the
reference's Pallas kernel in interpret mode, and one prefill chunk against
the reference's ``paged_prefill_chunk``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_platform_name", "cpu")

# One PyTorch thread a process: the tier-1 run puts six pytest workers on
# the machine's cores, where PyTorch's default of an OpenMP thread per core
# makes each worker's ops wait on the others' (tens of times slower).
torch.set_num_threads(1)

from repro.core.stamp import StampConfig as JStampConfig
from repro.kernels.paged_attention import paged_decode_attention as JPDA
from repro.models import lm as JLM
from repro.models.config import ModelConfig as JModelConfig
from repro.serving import kvcache as JKV
from repro.serving import paged_kvcache as JPKV
from repro.serving.engine import PagedEngineConfig as JPagedConfig
from repro.serving.engine import PagedServingEngine as JPaged

from repro_torch.core.stamp import StampConfig as TStampConfig
from repro_torch.kernels import paged_attention as TPA
from repro_torch.models import lm as TLM
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.serving import kvcache as TKV
from repro_torch.serving import paged_kvcache as TPKV
from repro_torch.serving.engine import PagedEngineConfig as TPagedConfig
from repro_torch.serving.engine import PagedServingEngine as TPaged
from test_torch_cuda import paged_pools

DIMS = dict(name="unified-test", family="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128)
JCFG, TCFG = JModelConfig(**DIMS), TModelConfig(**DIMS)
PROMPT_LENS = (20, 40, 12, 33, 26)
MAX_NEW = (14, 10, 16, 8, 12)
RTOL = 1e-5
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


@pytest.fixture(autouse=True)
def _reset_reference_switches():
    yield
    JLM.set_fused_cache_attention(False)
    JLM.set_fused_decode_matmul(False)


def _ecfg(**kw):
    return dict(dict(max_slots=3, prefill_chunk=16, max_seq=96,
                     block_size=16), **kw)


def _serves(stamp=None, **kw):
    kv = dict(quantized=True, num_hi=16)
    return (JLM.ServeConfig(stamp=stamp and JStampConfig(**stamp),
                            kv=JKV.KVCacheConfig(**kv), **kw),
            TLM.ServeConfig(stamp=stamp and TStampConfig(**stamp),
                            kv=TKV.KVCacheConfig(**kv), **kw))


def _drain(engine, prompts, max_new=MAX_NEW) -> dict:
    for p, m in zip(prompts, max_new):
        engine.submit(p, m)
    return {r.uid: np.asarray(r.out_tokens) for r in engine.run()}


def _assert_same(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for uid in a:
        np.testing.assert_array_equal(a[uid], b[uid], err_msg=f"uid={uid}")


@pytest.fixture(scope="module", params=[(3, 4), (5, 6)],
                ids=["3slots_lo4", "5slots_lo6"])
def contended(request, jparams, tparams, prompts):
    """The contended workload at ``request.param`` (slots, lo pages; 3
    slots preempt only once the pool is cut to 3 usable pages): the
    reference's two-call run and the port's runs in both modes."""
    slots, lo = request.param
    ecfg = _ecfg(max_slots=slots, num_lo_blocks=lo)
    jserve, tserve = _serves()
    jeng = JPaged(jparams, JCFG, jserve,
                  JPagedConfig(**ecfg, step_mode="two_call"))
    out = {"ref": (_drain(jeng, prompts), jeng)}
    for mode in ("two_call", "unified"):
        eng = TPaged(tparams, TCFG, tserve,
                     TPagedConfig(**ecfg, step_mode=mode), device="cpu")
        out[mode] = (_drain(eng, prompts), eng)
    return out


def test_two_call_matches_reference_two_call(contended):
    _assert_same(contended["two_call"][0], contended["ref"][0])


def test_two_call_matches_unified(contended):
    _assert_same(contended["two_call"][0], contended["unified"][0])


def test_workload_is_contended(contended):
    """Preemption, resume and three-chunk prompts did happen, and the
    two-call engine counts and schedules as the reference's."""
    eng = contended["two_call"][1]
    assert eng.stats["preemptions"] > 0 and eng.stats["resumes"] > 0
    chunks = {}
    for _, kind, payload in eng.events:
        if kind == "prefill_chunk":
            chunks[payload[0]] = chunks.get(payload[0], 0) + 1
    assert max(chunks.values()) >= 3
    ref = contended["ref"][1]
    assert {k: eng.stats[k] for k in ref.stats} == ref.stats
    assert [tuple(e) for e in eng.events] == [tuple(e) for e in ref.events]


def test_dispatches_per_step(contended):
    """Unified: one step function call a step; two-call: more on mixed
    steps, and no shape key counted (the reference counts none either)."""
    uni, two = contended["unified"][1], contended["two_call"][1]
    assert uni.stats["device_dispatches"] == uni.stats["steps"]
    assert uni.stats["recompiles"] == uni.compile_count() >= 2
    assert two.stats["device_dispatches"] > two.stats["steps"]
    assert two.stats["recompiles"] == 0


@pytest.mark.parametrize("attention", [False, True],
                         ids=["plain_attention", "decode_attention_kernel"])
def test_fused_stamp_two_call_matches_reference(jparams, tparams, prompts,
                                                attention):
    """Fused STaMP (K1 → K2 on the chunks, the decode matmul on the slots),
    with the decode attention through K4's ``n_pf = 0`` entry or not: the
    port's two-call tokens are the reference two-call engine's, and without
    the attention kernel also the port's unified engine's (with it, the
    unified step attends a chunk to its own quantized pages while the
    two-call chunk attends to its raw K/V, as in the reference)."""
    stamp = dict(num_hi_tokens=8, execution="fused")
    jserve, tserve = _serves(stamp, fused_cache_attention=attention)
    short, new = prompts[:3], MAX_NEW[:3]
    ref = _drain(JPaged(jparams, JCFG, jserve,
                        JPagedConfig(**_ecfg(step_mode="two_call"))),
                 short, new)
    two = _drain(TPaged(tparams, TCFG, tserve,
                        TPagedConfig(**_ecfg(step_mode="two_call")),
                        device="cpu"), short, new)
    _assert_same(two, ref)
    if not attention:
        uni = _drain(TPaged(tparams, TCFG, tserve, TPagedConfig(**_ecfg()),
                            device="cpu"), short, new)
        _assert_same(two, uni)


@pytest.mark.parametrize("block_size", [4, 16])
def test_paged_decode_attention_entry_matches_pallas(block_size):
    """``paged_decode_attention`` with the reference's signature against
    its Pallas kernel in interpret mode (GQA rep 4, lengths on and off the
    hi region's edge)."""
    spans = [(l - 1, l) for l in (5, 16, 17, 38)]
    entry, ht, lt = paged_pools(block_size, 16, spans, seed=9)
    jentry = {name: jnp.asarray(a.numpy()) for name, a in entry.items()}
    q = np.random.default_rng(5).standard_normal((4, 1, 8, 16)).astype(
        np.float32)
    lengths = np.array([l for _, l in spans], np.int32)
    want = JPDA(jentry, jnp.asarray(q), jnp.asarray(lengths),
                jnp.asarray(ht), jnp.asarray(lt), block_size, interpret=True)
    got = TPA.paged_decode_attention(entry, torch.from_numpy(q),
                                     torch.from_numpy(lengths),
                                     torch.from_numpy(np.array(ht)),
                                     torch.from_numpy(np.array(lt)),
                                     block_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("start,valid", [(0, 16), (16, 9)],
                         ids=["first_chunk", "continuation"])
def test_paged_prefill_chunk_matches_reference(jparams, tparams, start,
                                               valid):
    """One chunk of one request (fused STaMP at 8-bit rows, the decode
    matmul on): the pages it writes hold the reference's codes, and its
    logits agree within ``LOGIT_TOL``; a continuation chunk attends to
    the first chunk's pages."""
    stamp = dict(num_hi_tokens=16, execution="fused")
    jserve, tserve = _serves(stamp, fused_cache_attention=True,
                             fused_decode_matmul=True)
    pj = JPKV.PagedCacheConfig(block_size=8, num_lo_blocks=6,
                               num_hi_blocks=3, max_blocks_per_seq=4,
                               quant=jserve.kv)
    pt = TPKV.PagedCacheConfig(block_size=8, num_lo_blocks=6,
                               num_hi_blocks=3, max_blocks_per_seq=4,
                               quant=tserve.kv)
    jserve = JLM.ServeConfig(**{**jserve.__dict__, "paged": pj})
    tserve = TLM.ServeConfig(**{**tserve.__dict__, "paged": pt})
    jprep = JLM.prepare_fused_weights(jparams, JStampConfig(**stamp))
    tprep = TLM.prepare_fused_weights(tparams, TStampConfig(**stamp))
    prompt = np.random.default_rng(6).integers(0, 128, 25).astype(np.int32)
    ht = np.array([[1, 2]], np.int32)
    lt = np.array([[1, 2, 3, 4]], np.int32)
    jpools = JLM.init_paged_cache(JCFG, pj)
    tpools = TLM.init_paged_cache(TCFG, pt, device="cpu")
    chunks = [(0, 16)] + ([(16, 9)] if start else [])
    for s0, n in chunks:
        toks = np.zeros((1, 16), np.int32)
        toks[0, :n] = prompt[s0:s0 + n]
        pages = np.zeros(16, np.int32)
        offs = np.zeros(16, np.int32)
        ishi = np.zeros(16, bool)
        for t in range(n):
            is_hi, idx, off = TPKV.token_page_index(s0 + t, pt)
            pages[t] = (ht if is_hi else lt)[0, idx]
            offs[t], ishi[t] = off, is_hi
        jl, jpools = jax.jit(
            lambda p, pools, *a: JLM.paged_prefill_chunk(
                p, pools, *a, JCFG, jserve, first=s0 == 0))(
            jprep, jpools, jnp.asarray(toks), jnp.int32(s0),
            jnp.asarray(ht), jnp.asarray(lt), jnp.asarray(pages),
            jnp.asarray(offs), jnp.asarray(ishi), jnp.int32(n - 1))
        tl, tpools = TLM.paged_prefill_chunk(
            tprep, tpools, torch.from_numpy(toks), s0,
            torch.from_numpy(ht), torch.from_numpy(lt),
            torch.from_numpy(pages), torch.from_numpy(offs),
            torch.from_numpy(ishi), n - 1, TCFG, tserve)
    assert tl.shape == jl.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)
    jentry = jax.tree.map(np.asarray, jpools)
    for i, entry in enumerate(tpools):
        for name in ("k_hi", "v_hi", "k_lo", "v_lo"):
            jarr = jentry[next(iter(jentry))][name][i]
            np.testing.assert_array_equal(entry[name].numpy(), jarr,
                                          err_msg=f"layer {i} {name}")

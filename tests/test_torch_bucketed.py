"""The port's bucketed serving path against the JAX reference on the CPU:
the contiguous mixed-precision cache, the packed-cache decode attention
(K6's plain version against the Pallas kernel in interpret mode),
``prefill`` / ``decode_step`` at the reduced llama3-8b size (and one reduced
Arctic case: the FFN block is shared), and ``BucketedEngine`` against the
reference's, plus the port's bucketed and paged engines against each other.

Inputs are numpy arrays from seeded generators handed to both sides; weights
go to the port through ``from_jax_params``.  Tolerances:

* cache buffers (codes, f16 scales and zero points, bf16 K/V): exact
  against ``jax.jit`` of the reference;
* K6's plain version: ``RTOL = 1e-5`` of the output's largest magnitude
  (the same block order; XLA's and PyTorch's ``exp`` and dot products
  differ in the last f32 bit);
* ``prefill`` / ``decode_step`` logits within ``LOGIT_TOL = 0.1`` (a tenth of
  their spread; a wrong mask, position or scale moves them by O(1)), with
  chunk activations at 8 bits as in ``test_torch_model.py``: at the 8/4-bit
  mix a last-bit difference upstream of a 4-bit quantizer moves a code, and
  the inverse transform spreads that over a DWT block (measured: 0.96 on one
  row of three).  The decode steps start from the reference's own cache, so
  they test the decode step, not the prefill's drift (4-bit cache codes of
  K/V that differ by one bf16 step: the caches' mean |Δ| is held to 0.02);
* at the mix, against the reference run in a process of its own without
  XLA's excess precision: fused steps and the engine under the 8-bit rules
  above (measured: bit for bit); reference execution, and ``jax.jit`` of
  the reference in this process, within ``MIX_LOGIT_ALLOWANCE = 1.5``;
* ``flash_attention`` past one 2048-token chunk: ``RTOL`` against the
  reference's;
* the engine: ``test_torch_engine.py``'s teacher-forced rule (argmax equal
  wherever the reference's top-1/top-2 margin exceeds 0.1, logits within
  0.05 on average, first tokens equal) with every prompt row at 8 bits; at
  the serve path's 8/4-bit mix the first tokens agree and a stated
  allowance holds the rest (the 64-token bucket puts 56 rows of each prompt
  through 4-bit codes, and the code flips above move the logits by 0.06 on
  average; without excess precision in the reference none are left:
  ROADMAP §3).
"""

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

from repro.configs import arctic_480b as JARCTIC
from repro.configs import llama3_8b as JLLAMA
from repro.core.stamp import StampConfig as JStampConfig
from repro.kernels.cache_attention import (
    cache_decode_attention as j_cache_attention)
from repro.models import lm as JLM
from repro.models.config import ModelConfig as JModelConfig
from repro.serving import kvcache as JKV
from repro.serving.engine import BucketedEngine as JBucketed
from repro.serving.engine import EngineConfig as JEngineConfig

from repro_torch.configs import get_reduced
from repro_torch.core.stamp import StampConfig as TStampConfig
from repro_torch.kernels import ops as TO
from repro_torch.kernels.cache_attention import cache_decode_attention
from repro_torch.kernels.ref import cache_decode_attention_ref
from repro_torch.models import lm as TLM
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.serving import kvcache as TKV
from repro_torch.serving.engine import BucketedEngine as TBucketed
from repro_torch.serving.engine import EngineConfig as TEngineConfig
from repro_torch.serving.engine import PagedEngineConfig as TPagedConfig
from repro_torch.serving.engine import PagedServingEngine as TPaged
from test_torch_engine import _drain
from test_torch_moe import _forced_compare

RTOL = 1e-5
LOGIT_TOL = 0.1
CACHE_MEAN_TOL = 0.02
JCFG, TCFG = JLLAMA.reduced(), get_reduced("llama3-8b")
S, CAP, NUM_HI = 32, 48, 8


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def jparams():
    return JLM.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def tparams(jparams):
    return TLM.from_jax_params(jax.tree.map(np.asarray, jparams), TCFG)


@pytest.fixture(autouse=True)
def _reset_reference_switches():
    yield
    JLM.set_fused_cache_attention(False)
    JLM.set_fused_decode_matmul(False)


# ---------------------------------------------------------------------------
# the contiguous cache
# ---------------------------------------------------------------------------


def _assert_same(jtree: dict, ttree: dict) -> None:
    assert set(jtree) == set(ttree)
    for k, v in jtree.items():
        a = np.asarray(v)
        b = ttree[k]
        assert str(b.dtype).split(".")[-1] == str(a.dtype), k
        np.testing.assert_array_equal(a.astype(np.float32),
                                      b.float().numpy(), err_msg=k)


@pytest.mark.parametrize("quantized,s,num_hi,cap,pos", [
    (True, 20, 8, 32, (25, 20)),     # capacity padding, writes in lo
    (True, 12, 16, 24, (12, 14)),    # num_hi past the prompt: hi writes
    (True, 33, 4, 33, (3, 32)),      # no padding, one hi and one lo write
    (False, 20, 8, 32, (25, 20)),    # the bf16 cache
])
def test_contiguous_cache_matches_reference(quantized, s, num_hi, cap, pos):
    """``quantize_full`` (with the reference's tail padding), ``write_token``
    at a scalar and at per-slot positions, and the dequantized reads give
    ``jax.jit`` of the reference's buffers exactly; ``init_layer_cache`` and
    ``cache_bytes`` agree."""
    rng = np.random.default_rng(s + num_hi)
    b, g, hd = 2, 2, 16
    k = rng.standard_normal((b, s, g, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, g, hd)).astype(np.float32) * 3 + 1
    kn = rng.standard_normal((b, 1, g, hd)).astype(np.float32)
    vn = rng.standard_normal((b, 1, g, hd)).astype(np.float32)
    jcfg = JKV.KVCacheConfig(quantized=quantized, num_hi=num_hi)
    tcfg = TKV.KVCacheConfig(quantized=quantized, num_hi=num_hi)
    jent = jax.jit(lambda a, c: JKV.quantize_full(a, c, jcfg, capacity=cap))(
        jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16))
    tent = TKV.quantize_full(_t(k).bfloat16(), _t(v).bfloat16(), tcfg,
                             capacity=cap)
    _assert_same(jent, tent)
    zero = JKV.init_layer_cache(1, b, cap, g, hd, jcfg)
    _assert_same({n: a[0] for n, a in zero.items()},
                 TKV.init_layer_cache(b, cap, g, hd, tcfg))
    assert TKV.cache_bytes(tent) == JKV.cache_bytes(jent)
    write = jax.jit(lambda e, a, c, p: JKV.write_token(e, a, c, p, jcfg))
    for p in (np.int32(pos[0]), np.asarray(pos, np.int32)):
        jent = write(jent, jnp.asarray(kn, jnp.bfloat16),
                     jnp.asarray(vn, jnp.bfloat16), jnp.asarray(p))
        TKV.write_token(tent, _t(kn).bfloat16(), _t(vn).bfloat16(), _t(p),
                        tcfg)
        _assert_same(jent, tent)
    if quantized:
        jseg = jax.jit(lambda e: JKV.dequantize_segments(e, jcfg))(jent)
        tseg = TKV.dequantize_segments(tent)
        for a, t in zip(jax.tree.leaves(jseg),
                        [x for pair in tseg for x in pair]):
            np.testing.assert_array_equal(np.asarray(a, np.float32),
                                          t.float().numpy())
    jk, jv = JKV.dequantize_full(jent, jcfg)
    tk, tv = TKV.dequantize_full(tent, tcfg)
    np.testing.assert_array_equal(np.asarray(jk, np.float32),
                                  tk.float().numpy())
    np.testing.assert_array_equal(np.asarray(jv, np.float32),
                                  tv.float().numpy())


# ---------------------------------------------------------------------------
# K6's plain version against the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,lengths", [
    # (b, s, g, hd, h, num_hi, block_s): test_kernels.py's three shapes
    ((2, 288, 2, 64, 8, 32, 64), (271,)),
    ((1, 576, 4, 128, 8, 64, 128), (559,)),
    ((2, 160, 2, 64, 4, 32, 128), (143,)),
    # ragged per-slot lengths: one row inside the hi region (every lo
    # block masked), one inside lo block 0, one across three blocks
    ((3, 168, 2, 32, 8, 8, 32), (5, 30, 100)),
])
def test_cache_attention_plain_matches_pallas(shape, lengths):
    b, s, g, hd, h, num_hi, bs = shape
    rng = np.random.default_rng(42)
    k = rng.standard_normal((b, s, g, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, g, hd)).astype(np.float32)
    q = rng.standard_normal((b, 1, h, hd)).astype(np.float32)
    jcfg = JKV.KVCacheConfig(quantized=True, num_hi=num_hi)
    jent = jax.jit(lambda a, c: JKV.quantize_full(a, c, jcfg))(
        jnp.asarray(k), jnp.asarray(v))
    tent = TKV.quantize_full(_t(k), _t(v),
                             TKV.KVCacheConfig(quantized=True, num_hi=num_hi))
    length = np.asarray(lengths, np.int32)
    want = j_cache_attention(jent, jnp.asarray(q), jnp.asarray(length),
                             block_s=bs, interpret=True)
    got = cache_decode_attention_ref(tent, _t(q), _t(length), block_s=bs)
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) <= RTOL
    if bs == 2048 or s - num_hi <= bs:
        # the wrapper runs the plain version on CPU tensors, uncounted
        TO.reset_launch_counts()
        np.testing.assert_array_equal(
            cache_decode_attention(tent, _t(q), _t(length)).numpy(),
            got.numpy())
        assert TO.launch_counts()["cache_decode_attention"] == 0


# ---------------------------------------------------------------------------
# prefill and decode_step
# ---------------------------------------------------------------------------


def _pair(execution: str, capacity=CAP, num_hi_tokens=S):
    fused = execution == "fused"
    common = dict(cache_capacity=capacity, fused_cache_attention=fused,
                  fused_decode_matmul=fused)
    return (JLM.ServeConfig(stamp=JStampConfig(num_hi_tokens=num_hi_tokens,
                                               execution=execution),
                            kv=JKV.KVCacheConfig(quantized=True,
                                                 num_hi=NUM_HI), **common),
            TLM.ServeConfig(stamp=TStampConfig(num_hi_tokens=num_hi_tokens,
                                               execution=execution),
                            kv=TKV.KVCacheConfig(quantized=True,
                                                 num_hi=NUM_HI), **common))


def _prefills(jp, tp, jcfg, tcfg, execution, toks, lens):
    """Both sides' ``prefill`` of right-padded ``toks`` read at ``lens -
    1``: ``(jlogits, jcache, tlogits, tcache)``."""
    jserve, tserve = _pair(execution)
    if execution == "fused":
        jp = JLM.prepare_fused_weights(jp, jserve.stamp)
        tp = TLM.prepare_fused_weights(tp, tserve.stamp)
    jl, jc = jax.jit(lambda p, t, lp: JLM.prefill(
        p, {"tokens": t}, jcfg, jserve, last_pos=lp))(
        jp, jnp.asarray(toks), jnp.asarray(lens - 1))
    tl, tc = TLM.prefill(tp, _t(toks), tcfg, tserve, last_pos=_t(lens - 1))
    return jp, tp, jserve, tserve, np.asarray(jl), jc, tl.numpy(), tc


def _layer(jcache: dict, i: int) -> dict:
    """Layer ``i`` of the reference's period-stacked cache, as the port's
    per-layer dict."""
    return {k: _t(np.asarray(v)[i]) for k, v in jcache["0"].items()}


@pytest.fixture(scope="module", params=["fused", "reference"])
def llama_prefill(request, jparams, tparams):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, JCFG.vocab_size, (3, S)).astype(np.int32)
    lens = np.array([S, 20, 9], np.int32)
    out = _prefills(jparams, tparams, JCFG, TCFG, request.param, toks, lens)
    return dict(zip(("jp", "tp", "jserve", "tserve", "jl", "jc", "tl", "tc"),
                    out), lens=lens, execution=request.param)


def test_prefill_matches_reference(llama_prefill):
    """Logits at each row's last prompt token within ``LOGIT_TOL``; the
    cache has the reference's layout, and its dequantized K/V differ by at
    most ``CACHE_MEAN_TOL`` on average per layer (bit-equal at the first
    layer in fused execution)."""
    r = llama_prefill
    assert r["tl"].shape == r["jl"].shape
    assert np.abs(r["tl"] - r["jl"]).max() <= LOGIT_TOL
    assert len(r["tc"]) == TCFG.num_layers
    kv = r["tserve"].kv
    for i, entry in enumerate(r["tc"]):
        ref = _layer(r["jc"], i)
        assert {k: (v.shape, v.dtype) for k, v in entry.items()} == \
            {k: (v.shape, v.dtype) for k, v in ref.items()}
        if i == 0 and r["execution"] == "fused":
            for k in ref:
                assert torch.equal(entry[k], ref[k]), k
        for a, b in zip(TKV.dequantize_full(entry, kv, torch.float32),
                        TKV.dequantize_full(ref, kv, torch.float32)):
            assert float((a - b).abs().mean()) <= CACHE_MEAN_TOL, i


def test_decode_steps_match_reference(llama_prefill):
    """Two ``decode_step`` s at per-slot positions from the reference's
    prefill cache (the port's copy of it): logits within ``LOGIT_TOL`` —
    fused (K6's and K3's plain versions) and plain (dequantized segments,
    bf16 weights).  The first layer's cache after the steps is the
    reference's, bit for bit."""
    r = llama_prefill
    jcache = r["jc"]
    tcache = [_layer(jcache, i) for i in range(TCFG.num_layers)]
    tok = r["jl"].argmax(-1).astype(np.int32)
    step = jax.jit(lambda p, c, t, pos: JLM.decode_step(p, c, t, pos, JCFG,
                                                        r["jserve"]))
    for n in range(2):
        pos = r["lens"] + n
        jl, jcache = step(r["jp"], jcache, jnp.asarray(tok), jnp.asarray(pos))
        tl, tcache = TLM.decode_step(r["tp"], tcache, _t(tok), _t(pos), TCFG,
                                     r["tserve"])
        assert np.abs(tl.numpy() - np.asarray(jl)).max() <= LOGIT_TOL, n
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    if r["execution"] == "fused":
        ref = _layer(jcache, 0)
        for k in ref:
            assert torch.equal(tcache[0][k], ref[k]), k


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_attention_beyond_one_chunk_matches_reference(causal):
    """Past ``ATTN_CHUNK`` (2048) tokens the port walks query and KV chunks
    with the reference's running ``(m, l, acc)`` recurrence: 4096 tokens
    (two chunks each way) at reduced heads against ``jax.jit`` of the
    reference's ``flash_attention``, within ``RTOL`` of the output's largest
    magnitude (the same order of operations; the dot products' last bits
    differ)."""
    from repro.models import layers as JLayers
    from repro_torch.models import layers as TLayers
    assert TLayers.ATTN_CHUNK == JLayers.AttnChunks().q == 2048
    rng = np.random.default_rng(7)
    q = rng.standard_normal((1, 4096, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 4096, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, 4096, 2, 16)).astype(np.float32)
    want = jax.jit(lambda a, b, c: JLayers.flash_attention(
        a, b, c, causal=causal))(q, k, v)
    got = TLayers.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) <= RTOL


def test_init_cache_matches_reference():
    serve_j, serve_t = _pair("fused")
    jc = JLM.init_cache(JCFG, 3, CAP, serve_j)
    tc = TLM.init_cache(TCFG, 3, CAP, serve_t, device="cpu")
    assert len(tc) == TCFG.num_layers
    for i, entry in enumerate(tc):
        _assert_same({k: np.asarray(v)[i] for k, v in jc["0"].items()},
                     entry)


def test_arctic_prefill_and_decode_match_reference():
    """The MoE FFN block is shared with the paged path: reduced Arctic's
    ``prefill`` (fused: K1/K2 and K5's plain versions) and two decode steps
    from the reference's cache (routed experts, K3 and K6's plain versions)
    within ``LOGIT_TOL``."""
    jcfg, tcfg = JARCTIC.reduced(), get_reduced("arctic-480b")
    jp = JLM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TLM.from_jax_params(jax.tree.map(np.asarray, jp), tcfg)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    lens = np.array([S, 17], np.int32)
    jp, tp, jserve, tserve, jl, jc, tl, _ = _prefills(jp, tp, jcfg, tcfg,
                                                      "fused", toks, lens)
    assert np.abs(tl - jl).max() <= LOGIT_TOL
    tcache = [_layer(jc, i) for i in range(tcfg.num_layers)]
    tok = jl.argmax(-1).astype(np.int32)
    step = jax.jit(lambda p, c, t, pos: JLM.decode_step(p, c, t, pos, jcfg,
                                                        jserve))
    for n in range(2):
        jl, jc = step(jp, jc, jnp.asarray(tok), jnp.asarray(lens + n))
        tl, tcache = TLM.decode_step(tp, tcache, _t(tok), _t(lens + n), tcfg,
                                     tserve)
        assert np.abs(tl.numpy() - np.asarray(jl)).max() <= LOGIT_TOL, n
        tok = np.asarray(jl).argmax(-1).astype(np.int32)


def test_right_padding_moves_stamp_prefill_as_in_the_reference(jparams,
                                                                tparams):
    """The reference's bucketed engine calls its right-padded prefill
    identical to serving the prompt unpadded; under STaMP it is not: the
    sequence transform and the hi-precision rows span the pad tokens.  The
    port keeps the reference's padded form (so the engines agree).  At the
    serve path's 8/4-bit mix the padded and unpadded logits of a 20-token
    prompt differ by O(1) on both sides (measured 0.96 and 1.07), where a
    change that left the real tokens' codes alone would move them by a
    few bf16 steps."""
    jserve, tserve = _pair("fused", num_hi_tokens=NUM_HI)
    jp = JLM.prepare_fused_weights(jparams, jserve.stamp)
    tp = TLM.prepare_fused_weights(tparams, tserve.stamp)
    prompt = np.random.default_rng(0).integers(0, 512, 20).astype(np.int32)
    padded = np.zeros((1, S), np.int32)
    padded[0, :20] = prompt
    last = np.array([19], np.int32)
    jpad, _ = jax.jit(lambda p, t, lp: JLM.prefill(
        p, {"tokens": t}, JCFG, jserve, last_pos=lp))(
        jp, jnp.asarray(padded), jnp.asarray(last))
    jraw, _ = jax.jit(lambda p, t: JLM.prefill(p, {"tokens": t}, JCFG,
                                               jserve))(
        jp, jnp.asarray(prompt[None]))
    tpad, _ = TLM.prefill(tp, _t(padded), TCFG, tserve, last_pos=_t(last))
    traw, _ = TLM.prefill(tp, _t(prompt[None]), TCFG, tserve)
    j_moved = np.abs(np.asarray(jpad) - np.asarray(jraw)).max()
    t_moved = float((tpad - traw).abs().max())
    assert j_moved > 0.5 and t_moved > 0.5


# ---------------------------------------------------------------------------
# the bucketed engine
# ---------------------------------------------------------------------------

PROMPT_LENS = (20, 40, 12, 33, 26)
MAX_NEW = (6, 4, 8, 5, 7)
ENGINE = dict(max_batch=3, bucket=64, max_seq=96)


MIX_HI = 8                  # 8-bit rows of a 64-token bucket: the mix
MIX_DECISIVE_MISSED = 2     # of the decisive rows, at the 8/4-bit mix
MIX_MEAN_DEV = 0.1


def _serve(stamp_cls, kv_mod, num_hi_tokens):
    """STaMP in fused execution with ``num_hi_tokens`` 8-bit rows, decode
    attention through the packed-cache kernel."""
    return dict(stamp=stamp_cls(num_hi_tokens=num_hi_tokens,
                                execution="fused"),
                kv=kv_mod.KVCacheConfig(quantized=True, num_hi=16),
                fused_cache_attention=True)


def _reference_engine(jparams, prompts, num_hi_tokens) -> tuple:
    """The reference's bucketed engine, greedy: ``(tokens by uid, logits
    of every prefill and decode step)``."""
    jeng = JBucketed(jparams, JCFG, JLM.ServeConfig(**_serve(
        JStampConfig, JKV, num_hi_tokens)), JEngineConfig(**ENGINE))
    jsteps = []
    jpre, jdec = jeng._prefill, jeng._decode

    def rec_prefill(*args):
        out = jpre(*args)
        jsteps.append(np.array(out[0]))
        return out

    def rec_decode(*args):
        out = jdec(*args)
        jsteps.append(np.array(out[0]))
        return out

    jeng._prefill, jeng._decode = rec_prefill, rec_decode
    return _drain(jeng, prompts, MAX_NEW), jsteps


def _port_engine(tparams, prompts, num_hi_tokens, jsteps) -> dict:
    """The port's free greedy run and its run teacher-forced to the
    reference's logits ``jsteps``, with its own logits recorded."""
    def engine():
        return TBucketed(tparams, TCFG, TLM.ServeConfig(**_serve(
            TStampConfig, TKV, num_hi_tokens)), TEngineConfig(**ENGINE),
            device="cpu")

    TO.reset_launch_counts()
    tout = _drain(engine(), prompts, MAX_NEW)
    counts = TO.launch_counts()
    tsteps = []
    real_pre, real_dec = TLM.prefill, TLM.decode_step

    def forced(real):
        def call(*args, **kw):
            logits, cache = real(*args, **kw)
            tsteps.append(logits.numpy())
            return torch.from_numpy(jsteps[len(tsteps) - 1]), cache
        return call

    TLM.prefill, TLM.decode_step = forced(real_pre), forced(real_dec)
    try:
        forced_out = _drain(engine(), prompts, MAX_NEW)
    finally:
        TLM.prefill, TLM.decode_step = real_pre, real_dec
    return dict(tout=tout, forced=forced_out, tsteps=tsteps, counts=counts)


def _engine_prompts() -> list:
    rng = np.random.default_rng(2)
    return [rng.integers(0, 512, n) for n in PROMPT_LENS]


def _step_rows(steps) -> list:
    return [dict(pf=s, pf_length=np.ones(len(s)), dec=s[:0],
                 dec_pos=np.zeros(0)) for s in steps]


@pytest.fixture(scope="module", params=[ENGINE["bucket"], MIX_HI],
                ids=["8bit", "mix"])
def engine_runs(request, jparams, tparams):
    """The reference's bucketed engine with every prefill's and decode
    step's logits recorded; the port's free run; and the port's run
    teacher-forced to the reference's tokens, with its own logits."""
    prompts = _engine_prompts()
    jout, jsteps = _reference_engine(jparams, prompts, request.param)
    return dict(jout=jout, jsteps=jsteps, mix=request.param == MIX_HI,
                **_port_engine(tparams, prompts, request.param, jsteps))


def test_bucketed_engine_first_tokens_match_reference(engine_runs):
    """Free greedy runs: every request's first token (the right-padded
    prefill's logits at its last prompt token) is the reference's, every
    request yields its full count, and on the CPU no kernel launched."""
    jout, tout = engine_runs["jout"], engine_runs["tout"]
    assert set(jout) == set(tout) == {1, 2, 3, 4, 5}
    for uid in jout:
        assert len(tout[uid]) == len(jout[uid]) == MAX_NEW[uid - 1]
        assert tout[uid][0] == jout[uid][0], f"uid={uid}"
    assert set(engine_runs["counts"].values()) == {0}


def test_bucketed_engine_teacher_forced_argmax_matches_reference(
        engine_runs):
    """Teacher-forced to the reference's tokens, the port's pick is the
    reference's on every row of every prefill and decode step whose
    reference top-1/top-2 margin exceeds 0.1, half the rows are decisive
    (``test_torch_moe.py``'s floor for a 512-token vocabulary, whose top two
    sit closer than the 128-token test model's), and logits agree to 0.05
    on average.  At the 8/4-bit mix at most
    ``MIX_DECISIVE_MISSED`` decisive rows pick another token and logits
    agree to ``MIX_MEAN_DEV`` on average (measured: 2 rows, 0.06); the
    reference's compiled excess precision is the cause
    (``test_mix_engine_matches_reference_without_excess_precision``)."""
    for uid, toks in engine_runs["jout"].items():
        np.testing.assert_array_equal(engine_runs["forced"][uid], toks)
    jsteps, tsteps = engine_runs["jsteps"], engine_runs["tsteps"]
    assert len(tsteps) == len(jsteps)

    live, decisive, missed, dev = _forced_compare(_step_rows(jsteps),
                                                  _step_rows(tsteps))
    assert live >= sum(MAX_NEW) and decisive >= 0.5 * live
    if engine_runs["mix"]:
        assert missed <= MIX_DECISIVE_MISSED and dev <= MIX_MEAN_DEV
    else:
        assert missed == 0 and dev <= 0.05


# ---------------------------------------------------------------------------
# the 8/4-bit mix against the reference without XLA's excess precision
# ---------------------------------------------------------------------------

# At the mix the port parts from ``jax.jit`` of the reference (0.96 on one
# prefill row of three, two decisive engine rows); a process of its own runs
# the reference with ``--xla_allow_excess_precision=false`` (the flag must
# reach XLA before its backend starts), so that every bf16 value the
# reference's compiled step computes is rounded where the program says.
MIX_LOGIT_ALLOWANCE = 1.5   # where the port is not held to LOGIT_TOL at the mix


def _mix_inputs() -> tuple:
    rng = np.random.default_rng(0)
    toks = rng.integers(0, JCFG.vocab_size, (3, S)).astype(np.int32)
    return toks, np.array([S, 20, 9], np.int32)


def _reference_steps(jparams, execution: str) -> list:
    """The reference's ``prefill`` of ``_mix_inputs`` with ``MIX_HI`` 8-bit
    rows, then two greedy ``decode_step`` s from its own cache: the three
    steps' logits."""
    jserve, _ = _pair(execution, num_hi_tokens=MIX_HI)
    jp = (JLM.prepare_fused_weights(jparams, jserve.stamp)
          if execution == "fused" else jparams)
    toks, lens = _mix_inputs()
    logits, cache = jax.jit(lambda p, t, lp: JLM.prefill(
        p, {"tokens": t}, JCFG, jserve, last_pos=lp))(
        jp, jnp.asarray(toks), jnp.asarray(lens - 1))
    out = [np.asarray(logits)]
    step = jax.jit(lambda p, c, t, pos: JLM.decode_step(p, c, t, pos, JCFG,
                                                        jserve))
    for n in range(2):
        tok = out[-1].argmax(-1).astype(np.int32)
        logits, cache = step(jp, cache, jnp.asarray(tok),
                             jnp.asarray(lens + n))
        out.append(np.asarray(logits))
    return out


def _port_steps(tparams, execution: str, jsteps) -> list:
    """The port's steps of ``_reference_steps`` from its own cache, each
    decode step fed the reference's greedy token."""
    _, tserve = _pair(execution, num_hi_tokens=MIX_HI)
    tp = (TLM.prepare_fused_weights(tparams, tserve.stamp)
          if execution == "fused" else tparams)
    toks, lens = _mix_inputs()
    logits, cache = TLM.prefill(tp, _t(toks), TCFG, tserve,
                                last_pos=_t(lens - 1))
    out = [logits.numpy()]
    for n in range(2):
        tok = jsteps[n].argmax(-1).astype(np.int32)
        logits, cache = TLM.decode_step(tp, cache, _t(tok), _t(lens + n),
                                        TCFG, tserve)
        out.append(logits.numpy())
    return out


def reference_mix_run(out: str) -> None:
    """The reference's side of the mix tests, written to ``out``: the steps
    of ``_reference_steps`` in both executions and the bucketed engine's
    tokens and step logits.  Run in a process whose ``XLA_FLAGS`` are set."""
    jparams = JLM.init_params(jax.random.PRNGKey(0), JCFG)
    for execution in ("fused", "reference"):
        np.save(f"{out}/{execution}_steps.npy",
                np.stack(_reference_steps(jparams, execution)))
    jout, jsteps = _reference_engine(jparams, _engine_prompts(), MIX_HI)
    np.savez(f"{out}/engine_steps.npz", *jsteps)
    np.savez(f"{out}/engine_tokens.npz",
             **{str(uid): toks for uid, toks in jout.items()})


@pytest.fixture(scope="module")
def without_excess_precision(tmp_path_factory):
    """``reference_mix_run`` in a subprocess with XLA's excess precision
    off, under a 300 s limit of its own."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    out = tmp_path_factory.mktemp("no_excess_precision")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_allow_excess_precision=false").strip()
    env["PYTHONPATH"] = os.pathsep.join(
        [str(Path(__file__).resolve().parent)] +
        [p for p in sys.path if p])
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, test_torch_bucketed as t; "
         "t.reference_mix_run(sys.argv[1])", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-3000:]
    return out


@pytest.mark.parametrize("execution", ["fused", "reference"])
def test_mix_steps_match_reference_without_excess_precision(
        execution, without_excess_precision, jparams, tparams):
    """At the mix, in fused execution (the serve path), the port's
    ``prefill`` and two ``decode_step`` s from its own cache are within
    ``LOGIT_TOL`` of the reference run without excess precision (measured:
    0.0 at all three steps, bit for bit).  Against ``jax.jit`` of the
    reference in this process the prefill parts by up to
    ``MIX_LOGIT_ALLOWANCE`` (measured 0.96, on one row of three): the first
    difference is layer 0's RMSNorm output after the attention residual
    (304 elements a bf16 step apart, while the out-projection's output is
    equal); a step there moves a 4-bit code, which the inverse transform
    spreads over a DWT block.

    Reference execution keeps a remainder without excess precision: given
    the same input, its compiled STaMP round trip lands one or two
    elements a bf16 step away from the port's, and at the mix that moves
    codes downstream (measured off / on: prefill 0.70 / 0.80, decode
    steps 0.28 and 0.23 off); it is held to ``MIX_LOGIT_ALLOWANCE``."""
    off = np.load(without_excess_precision / f"{execution}_steps.npy")
    got = _port_steps(tparams, execution, off)
    tol = LOGIT_TOL if execution == "fused" else MIX_LOGIT_ALLOWANCE
    for n, (a, b) in enumerate(zip(got, off)):
        assert np.abs(a - b).max() <= tol, n
    on = _reference_steps(jparams, execution)
    assert np.abs(got[0] - on[0]).max() <= MIX_LOGIT_ALLOWANCE


def test_mix_engine_matches_reference_without_excess_precision(
        without_excess_precision, tparams):
    """The engine at the mix against the reference's engine without excess
    precision, under the 8-bit rule with no allowance: first tokens equal,
    teacher-forced argmax equal on every decisive row, logits within 0.05
    on average.  (``jax.jit`` in this process needs
    ``MIX_DECISIVE_MISSED``.)"""
    z = np.load(without_excess_precision / "engine_steps.npz")
    jsteps = [z[f"arr_{i}"] for i in range(len(z.files))]
    jout = {int(k): v for k, v in
            np.load(without_excess_precision / "engine_tokens.npz").items()}
    port = _port_engine(tparams, _engine_prompts(), MIX_HI, jsteps)
    for uid, toks in jout.items():
        assert port["tout"][uid][0] == toks[0], f"uid={uid}"
        np.testing.assert_array_equal(port["forced"][uid], toks)
    live, decisive, missed, dev = _forced_compare(
        _step_rows(jsteps), _step_rows(port["tsteps"]))
    assert live >= sum(MAX_NEW) and decisive >= 0.5 * live
    assert missed == 0 and dev <= 0.05


# ---------------------------------------------------------------------------
# the port's two engines against each other
# ---------------------------------------------------------------------------

PARITY_DIMS = dict(name="paged-test", family="dense", num_layers=2,
                   d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                   vocab_size=128)


@pytest.mark.parametrize("quantized", [True, False], ids=["quant", "bf16"])
def test_bucketed_and_paged_engines_token_identical(quantized):
    """``tests/test_paged_serving.py``'s parity settings without STaMP: the
    quantized cache (num_hi 16) and the bf16 one.  The port's bucketed
    engine (one padded prefill, contiguous cache) and its paged engine
    (64-token chunks, 16-token pages) decode the same tokens, as the
    reference's two engines do."""
    jcfg, tcfg = JModelConfig(**PARITY_DIMS), TModelConfig(**PARITY_DIMS)
    tp = TLM.from_jax_params(jax.tree.map(
        np.asarray, JLM.init_params(jax.random.PRNGKey(0), jcfg)), tcfg)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 128, n) for n in (20, 45, 12, 30, 26)]
    max_new = (6, 4, 8, 5, 7)
    serve = TLM.ServeConfig(kv=TKV.KVCacheConfig(quantized=quantized,
                                                 num_hi=16))
    bucketed = _drain(TBucketed(tp, tcfg, serve,
                                TEngineConfig(max_batch=5, bucket=64,
                                              max_seq=96), device="cpu"),
                      prompts, max_new)
    paged = _drain(TPaged(tp, tcfg, serve,
                          TPagedConfig(max_slots=5, prefill_chunk=64,
                                       max_seq=96, block_size=16),
                          device="cpu"), prompts, max_new)
    assert set(bucketed) == set(paged) == {1, 2, 3, 4, 5}
    for uid in bucketed:
        assert len(bucketed[uid]) == max_new[uid - 1]
        np.testing.assert_array_equal(bucketed[uid], paged[uid],
                                      err_msg=f"uid={uid}")


def test_bucketed_engine_validates_requests(tparams):
    serve = TLM.ServeConfig(kv=TKV.KVCacheConfig(quantized=True, num_hi=4))
    eng = TBucketed(tparams, TCFG, serve, TEngineConfig(
        max_batch=2, bucket=16, max_seq=24), device="cpu")
    with pytest.raises(ValueError):
        eng.submit(np.zeros(0, np.int32))
    with pytest.raises(ValueError):
        eng.submit(np.arange(17) % 512)          # past the bucket
    with pytest.raises(ValueError):
        eng.submit(np.array([0, 512]))           # outside the vocabulary
    with pytest.raises(ValueError):
        eng.submit(np.arange(4), 0)
    eng.submit(np.arange(16), 30)                # cut to max_seq - 16
    done = eng.run()
    assert [len(r.out_tokens) for r in done] == [8]
    assert eng.stats["steps"] == 9 and eng.stats["finished"] == 1

"""The port's hybrid (Jamba-1.5-Large) and pure-SSM (Mamba2-1.3B) stacks
against the JAX reference on the CPU, at their reduced configs.

Both sides run the reference's weights (``from_jax_params``) on the same
numpy-seeded inputs: the reference with its Pallas kernels in interpret
mode, the port with its kernels' plain versions.  Held here:

* the configs field for field and the hybrid ``layer_plan`` (attention at
  ``p // 2`` of each period, MoE every ``moe_period``-th layer, the
  divisibility error);
* ``ssd_chunked`` and ``causal_conv1d`` against the reference's in f32,
  within ``SSD_RTOL`` relative: XLA's and PyTorch's ``exp`` differ in the
  last bit and SSD exponentiates cumulative sums, so the two agree to
  rounding, not bit for bit;
* the calibration forward and PTQ (the Mamba projections' packed codes
  bit for bit);
* the hybrid-state contracts of ``tests/test_hybrid_paged.py`` on the
  port: the SSM pool's shapes and null slot, its analytic bytes per slot,
  the swap round trip carrying SSM state (and refusing without a slot),
  inactive slots keeping their state bit for bit, chunked state equal to
  one-shot state, padded prefill state equal to unpadded, pageless
  serving of more requests than slots, prefix caching off with Mamba
  layers;
* the engines against the reference's: the paged unified engine, the
  two-call engine and the bucketed engine each give the reference's
  greedy tokens, the reference run in a process of its own with
  ``--xla_allow_excess_precision=false`` (in-process, its compiled STaMP
  round trips keep bf16 chains in f32: ``ROADMAP.md`` §3).  Mamba2 is
  token-identical on every request; Jamba, whose MoE layers carry the
  8/4-bit mix's remainder, keeps Arctic's allowances
  (``test_torch_moe.py``: ``MIX_FIRST_TOKENS_AGREE``,
  ``MIX_DECISIVE_MISSED``) and nothing looser.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

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

from repro import configs as JCONFIGS
from repro.core import ptq as JPTQ
from repro.data import pipeline as JDATA
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.serving import paged_kvcache as JPKV

from repro_torch import configs as TCONFIGS
from repro_torch.core import ptq as TPTQ
from repro_torch.core.stamp import StampConfig as TStampConfig
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.models.config import LayerSpec
from repro_torch.serving import kvcache as TKV
from repro_torch.serving import paged_kvcache as TPKV
from repro_torch.serving.engine import (BucketedEngine, EngineConfig,
                                        PagedEngineConfig,
                                        PagedServingEngine)

from test_torch_archs import _init, _shared_fields
from test_torch_moe import MIX_DECISIVE_MISSED, MIX_FIRST_TOKENS_AGREE

ARCHS = ("mamba2-1.3b", "jamba-1.5-large-398b")
MAMBA2, JAMBA = ARCHS
PROMPT_LENS = (20, 33, 12, 27)     # 33 and 27 take two 16-token chunks
MAX_NEW = (5, 3, 4, 4)
ENGINE = dict(max_slots=2, prefill_chunk=16, max_seq=64, block_size=16)
BUCKET = dict(max_batch=4, bucket=64, max_seq=96)
ENGINE_TIMEOUT_S = 300
SSD_RTOL = 2e-5
LOGIT_TOL = 0.1
QUANT = TKV.KVCacheConfig(quantized=True, num_hi=16)


@pytest.fixture(autouse=True)
def _reset_reference_switches():
    yield
    JLM.set_fused_cache_attention(False)
    JLM.set_fused_decode_matmul(False)


def _prompts(vocab: int) -> list:
    rng = np.random.default_rng(2)
    return [rng.integers(0, vocab, n) for n in PROMPT_LENS]


def _serve(lm_mod, stamp_cls, kv_mod):
    return lm_mod.ServeConfig(
        stamp=stamp_cls(num_hi_tokens=8, execution="fused"),
        kv=kv_mod.KVCacheConfig(quantized=True, num_hi=16),
        fused_cache_attention=True)


# The reference's three engines on one reduced arch (weights and prompts
# from the pickle ``argv[2] + ".in"``): the paged unified engine with every
# step's logits recorded, the two-call engine and the bucketed engine; run
# in a process of its own so that XLA_FLAGS reaches the backend first.
_REFERENCE_ENGINES = """
import pickle
import sys
import jax
import jax.numpy as jnp
import numpy as np
jax.config.update("jax_platform_name", "cpu")
from repro import configs
from repro.core.stamp import StampConfig
from repro.models import lm as JLM
from repro.serving import kvcache as JKV
from repro.serving.engine import (BucketedEngine, EngineConfig,
                                  PagedEngineConfig, PagedServingEngine)

arch, path = sys.argv[1], sys.argv[2]
with open(path + ".in", "rb") as f:
    params, prompts, max_new, engine, bucket = pickle.load(f)
params = jax.tree.map(jnp.asarray, params)
cfg = configs.get_reduced(arch)
serve = JLM.ServeConfig(
    stamp=StampConfig(num_hi_tokens=8, execution="fused"),
    kv=JKV.KVCacheConfig(quantized=True, num_hi=16),
    fused_cache_attention=True)


def drain(eng):
    for p, m in zip(prompts, max_new):
        eng.submit(p, m)
    out = {r.uid: np.asarray(r.out_tokens) for r in eng.run()}
    JLM.set_fused_cache_attention(False)
    JLM.set_fused_decode_matmul(False)
    return out


eng = PagedServingEngine(params, cfg, serve, PagedEngineConfig(**engine))
steps = []
step = eng._unified


def record(*args):
    out = step(*args)
    steps.append(dict(pf_length=np.asarray(args[4]),
                      dec_active=np.asarray(args[10]),
                      pf=np.asarray(out[0]), dec=np.asarray(out[1])))
    return out


eng._unified = record
outs = {"unified": drain(eng)}
outs["two_call"] = drain(PagedServingEngine(
    params, cfg, serve, PagedEngineConfig(step_mode="two_call", **engine)))
outs["bucketed"] = drain(BucketedEngine(params, cfg, serve,
                                        EngineConfig(**bucket)))
with open(path + ".out", "wb") as f:
    pickle.dump((outs, steps), f)
"""


def _start_reference(arch: str, jparams, path: str) -> subprocess.Popen:
    with open(path + ".in", "wb") as f:
        pickle.dump((jax.tree.map(np.asarray, jparams),
                     _prompts(JCONFIGS.get_reduced(arch).vocab_size),
                     MAX_NEW, ENGINE, BUCKET), f)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_allow_excess_precision=false").strip()
    return subprocess.Popen(
        [sys.executable, "-c", _REFERENCE_ENGINES, arch, path], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """Every arch's reference weights (seed 0) and its reference engines,
    all started together with the module's first arch so that they run
    beside the archs' other tests."""
    out = {}
    for arch in ARCHS:
        jparams = _init(JCONFIGS.get_reduced(arch), 0)
        path = str(tmp_path_factory.mktemp("hybrid") / arch)
        out[arch] = (jparams, _start_reference(arch, jparams, path), path)
    yield out
    for _, proc, _ in out.values():
        proc.kill()


@pytest.fixture(scope="module", params=ARCHS)
def case(request, references):
    """One reduced arch: both configs, the reference's weights and the
    port's copy, and its reference engines' process."""
    arch = request.param
    jcfg, tcfg = JCONFIGS.get_reduced(arch), TCONFIGS.get_reduced(arch)
    jparams, proc, path = references[arch]
    tparams = TLM.from_jax_params(jax.tree.map(np.asarray, jparams), tcfg)
    return dict(arch=arch, jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                tparams=tparams, engine=(proc, path))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_layer_plans_equal_the_reference(arch):
    """``CONFIG`` and ``reduced()`` equal the reference's on every field,
    with the derived SSM widths, and the layer plans agree spec by spec
    (Jamba: attention at 4 of each 8, MoE on every odd layer)."""
    for j, t in ((JCONFIGS.get_config(arch), TCONFIGS.get_config(arch)),
                 (JCONFIGS.get_reduced(arch), TCONFIGS.get_reduced(arch))):
        for name, (jv, tv) in _shared_fields(j, t).items():
            assert jv == tv, f"{arch}.{name}: {jv!r} != {tv!r}"
        for prop in ("d_inner", "ssm_heads", "padded_vocab"):
            assert getattr(j, prop) == getattr(t, prop), prop
        jpro, jper, jn = j.layer_plan()
        tpro, tper, tn = t.layer_plan()
        assert jn == tn and len(jpro) == len(tpro) == 0
        assert [(s.mixer, s.ffn) for s in jper] == \
            [(s.mixer, s.ffn) for s in tper]
    assert TCONFIGS.canonical(arch) == JCONFIGS.canonical(arch)


def test_hybrid_layer_plan_places_attention_and_moe():
    """Jamba's period: attention at position 4, Mamba elsewhere, MoE at
    the odd positions; a depth that is not a whole number of periods
    raises, as in the reference; an audio (enc-dec) or VLM backbone's
    plan is the dense one, as the reference's is."""
    cfg = TCONFIGS.get_config(JAMBA)
    _, period, nper = cfg.layer_plan()
    assert nper == 9 and len(period) == 8
    assert [s.mixer for s in period] == ["mamba"] * 4 + ["attn"] + \
        ["mamba"] * 3
    assert [s.ffn for s in period] == ["mlp", "moe"] * 4
    with pytest.raises(ValueError, match="not divisible by period 8"):
        dataclasses.replace(cfg, num_layers=12).layer_plan()
    assert TCONFIGS.get_config(MAMBA2).layer_specs() == \
        (LayerSpec("mamba", "none"),) * 48
    for family in ("audio", "vlm"):
        tplan = dataclasses.replace(cfg, family=family).layer_plan()
        jplan = dataclasses.replace(JCONFIGS.get_config(JAMBA),
                                    family=family).layer_plan()
        assert tplan == ((), (LayerSpec("attn", "mlp"),), 72)
        assert [(s.mixer, s.ffn) for s in jplan[1]] == [("attn", "mlp")]
        assert jplan[0] == () and jplan[2] == 72


# ---------------------------------------------------------------------------
# SSD and the causal conv against the reference
# ---------------------------------------------------------------------------


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("s,chunk,with_state", [(32, 16, False),
                                                (48, 16, True),
                                                (64, 64, True)])
def test_ssd_chunked_matches_reference(s, chunk, with_state):
    """SSD in f32 over one or several chunks, from zero or a carried state:
    outputs and final state within ``SSD_RTOL`` of the reference's."""
    rng = np.random.default_rng(s)
    b, h, p, n = 2, 4, 8, 16
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 2)).astype(
        np.float32)
    a_log = (rng.standard_normal(h) * 0.5).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    st = rng.standard_normal((b, h, p, n)).astype(np.float32) \
        if with_state else None
    jy, js = JL.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, a_log, bm,
                                                       cm)),
                            chunk=chunk, init_state=None if st is None
                            else jnp.asarray(st))
    ty, ts = TL.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, a_log,
                                                            bm, cm)),
                            chunk=chunk, init_state=None if st is None
                            else torch.from_numpy(st))
    assert ty.shape == jy.shape and ts.shape == js.shape
    assert _rel(ty.numpy(), jy) <= SSD_RTOL
    assert _rel(ts.numpy(), js) <= SSD_RTOL


def test_causal_conv1d_matches_reference():
    """The depthwise conv + silu in f32 within ``SSD_RTOL``, from zeros and
    from a carried tail, and the tail gathered at each row's valid
    boundary (``lengths``) exactly."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 10, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    cache = rng.standard_normal((3, 3, 24)).astype(np.float32)
    lengths = np.array([10, 4, 1], np.int32)
    for c, ln in ((None, None), (cache, None), (cache, lengths)):
        jy, jc = JL.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                  cache=None if c is None
                                  else jnp.asarray(c),
                                  lengths=None if ln is None
                                  else jnp.asarray(ln))
        ty, tc = TL.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                                  cache=None if c is None
                                  else torch.from_numpy(c),
                                  lengths=None if ln is None
                                  else torch.from_numpy(ln))
        assert _rel(ty.numpy(), jy) <= SSD_RTOL
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


# ---------------------------------------------------------------------------
# calibration forward and PTQ
# ---------------------------------------------------------------------------


def test_calibration_layers_match_reference(case):
    """The calibration forward (bf16, no quantizer) layer by layer, each
    layer fed the reference's input: within 5e-2 of the reference's
    output, as the dense archs' whole forward is.  (Across Jamba's 8
    layers the bf16 last-bit differences of each layer compound through
    its MoE routing to 0.2 at the final norm, so each layer is held on its
    own input.)"""
    jcfg, tcfg = case["jcfg"], case["tcfg"]
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    x = JLM._embed(case["jparams"], jnp.asarray(tokens))
    _, period, nper = jcfg.layer_plan()
    kv = JLM.KV.KVCacheConfig(quantized=False)
    for i in range(nper):
        for j, spec in enumerate(period):
            pj = jax.tree.map(lambda a, i=i: a[i],
                              case["jparams"]["period"][j])
            tx, _ = TLM.prefill_layer(
                case["tparams"]["layers"][i * len(period) + j],
                tcfg.layer_specs()[i * len(period) + j],
                torch.from_numpy(np.asarray(x, np.float32)).to(
                    torch.bfloat16), tcfg)
            x, _ = JLM.apply_block(spec, pj, x, jcfg, mode="train",
                                   positions=jnp.arange(32)[None],
                                   policy=None, stamp=None, kv_cfg=kv)
            np.testing.assert_allclose(tx.float().numpy(),
                                       np.asarray(x, np.float32),
                                       atol=5e-2, err_msg=f"layer {i}/{j}")


def test_ptq_packs_the_mamba_projections_as_the_reference(case):
    """Same calibration batches and weights: the same ``num_hi`` and
    bit-identical packed int4 ``in_proj`` / ``out_proj`` in every Mamba
    layer (and the attention and MLP sites of Jamba's)."""
    jcfg, tcfg = case["jcfg"], case["tcfg"]
    batches = JDATA.calibration_batches(
        JDATA.DataConfig(vocab_size=jcfg.vocab_size, seq_len=64,
                         global_batch=2), 1)
    jsp, _, jrep = JPTQ.calibrate_and_quantize(case["jparams"], batches,
                                               jcfg)
    tsp, _, trep = TPTQ.calibrate_and_quantize(case["tparams"], batches,
                                               tcfg, device="cpu")
    assert trep.num_hi == jrep.num_hi and trep.avg_bits == jrep.avg_bits
    _, period, nper = tcfg.layer_plan()
    checked = 0
    for i in range(nper):
        for j, spec in enumerate(period):
            layer = tsp["layers"][i * len(period) + j]
            names = ["in_proj", "out_proj"] if spec.mixer == "mamba" \
                else ["wq", "wo"]
            if spec.ffn == "mlp":
                names.append("wo_mlp")
            for name in names:
                for part in ("q", "scale", "zp"):
                    np.testing.assert_array_equal(
                        layer[name][part].numpy(),
                        np.asarray(jsp["period"][j][name][part])[i],
                        err_msg=f"{i}/{j}/{name}.{part}")
                checked += 1
    assert checked >= 2 * tcfg.num_layers


# ---------------------------------------------------------------------------
# the SSM state pool and the hybrid-state contracts (the port's own)
# ---------------------------------------------------------------------------


def _tparams(arch: str, seed: int = 0) -> dict:
    return TLM.init_params(TCONFIGS.get_reduced(arch), seed=seed,
                           device="cpu")


def _pcfg(quant=QUANT) -> TPKV.PagedCacheConfig:
    return TPKV.PagedCacheConfig(block_size=16, num_lo_blocks=8,
                                 num_hi_blocks=4, max_blocks_per_seq=5,
                                 quant=quant)


def _ssm(pools: list) -> list:
    return [e for e in pools if TPKV.is_ssm_entry(e)]


def test_pool_shapes_null_slot_and_bytes_per_slot():
    """Reduced Jamba at 3 slots: 7 Mamba layers of slot-dense state with
    the null slot as row 3 and 1 attention layer of page pools; the bytes a
    slot pins equal the analytic count (and the reference's for the same
    stack)."""
    cfg = TCONFIGS.get_reduced(JAMBA)
    pools = TLM.init_paged_cache(cfg, _pcfg(), device="cpu", num_slots=3)
    ssm = _ssm(pools)
    assert len(ssm) == 7 and len(pools) - len(ssm) == 1
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    for e in ssm:
        assert e["state"].shape == (4, cfg.ssm_heads, cfg.ssm_head_dim,
                                    cfg.ssm_state)
        assert e["state"].dtype == torch.float32
        assert e["conv"].shape == (4, cfg.conv_width - 1, conv_dim)
        assert e["conv"].dtype == torch.bfloat16
    want = 7 * (cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4 +
                (cfg.conv_width - 1) * conv_dim * 2)
    assert TPKV.ssm_state_bytes_per_slot(pools) == want
    jcfg = JCONFIGS.get_reduced(JAMBA)
    jpools = JLM.init_paged_cache(jcfg, JPKV.PagedCacheConfig(
        block_size=16, num_lo_blocks=8, num_hi_blocks=4,
        max_blocks_per_seq=5, quant=JLM.KV.KVCacheConfig(
            quantized=True, num_hi=16)), num_slots=3)
    assert JPKV.ssm_state_bytes_per_slot(jpools) == want


def test_swap_round_trip_carries_ssm_state():
    """Extract at slot 1, insert at slot 2: the SSM rows (f32 state and
    bf16 conv tail) arrive bit for bit with the pages; extract or insert
    without a slot raises."""
    cfg = TCONFIGS.get_reduced(JAMBA)
    pools = TLM.init_paged_cache(cfg, _pcfg(), device="cpu", num_slots=3)
    gen = torch.Generator().manual_seed(0)
    for e in pools:
        for t in e.values():
            t.copy_((torch.randn(t.shape, generator=gen) * 5).to(t.dtype))
    saved = TPKV.extract_pages(pools, [1], [1, 2], slot=1)
    TPKV.insert_pages(pools, saved, [2], [3, 4], slot=2)
    for e in _ssm(pools):
        for name in ("state", "conv"):
            assert torch.equal(e[name][2], e[name][1])
    attn = [e for e in pools if not TPKV.is_ssm_entry(e)][0]
    assert torch.equal(attn["k_lo"][3], attn["k_lo"][1])
    with pytest.raises(ValueError, match="slot"):
        TPKV.extract_pages(pools, [1], [1])
    with pytest.raises(ValueError, match="slot"):
        TPKV.insert_pages(pools, saved, [1], [1])


def test_hybrid_pools_without_num_slots_raise():
    with pytest.raises(ValueError, match="num_slots"):
        TLM.init_paged_cache(TCONFIGS.get_reduced(JAMBA), _pcfg(),
                             device="cpu")


def _decode_pools(params, cfg, active) -> tuple:
    """A paged decode step over fresh pools with state filled at random;
    returns (pools before, pools after)."""
    pcfg = _pcfg(TKV.KVCacheConfig(quantized=False))
    pools = TLM.init_paged_cache(cfg, pcfg, device="cpu",
                                 num_slots=len(active))
    gen = torch.Generator().manual_seed(1)
    for e in _ssm(pools):
        for t in e.values():
            t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))
    before = [{k: v.clone() for k, v in e.items()} for e in pools]
    s = len(active)
    z = torch.zeros(s, dtype=torch.int32)
    serve = TLM.ServeConfig(stamp=None,
                            kv=TKV.KVCacheConfig(quantized=False),
                            paged=pcfg)
    TLM.paged_decode_step(params, pools, z, z,
                          torch.zeros((s, 0), dtype=torch.int32),
                          torch.zeros((s, 5), dtype=torch.int32), z, z,
                          torch.zeros(s, dtype=torch.bool), cfg, serve,
                          active=torch.tensor(active))
    return before, pools


@pytest.mark.parametrize("active", [(False, False, False),
                                    (False, True, False)])
def test_inactive_slots_keep_their_state_bit_for_bit(active):
    """A decode step over the slot array leaves every inactive slot's
    conv and SSM state (and the null slot's) bit-identical, and advances
    an active slot's."""
    cfg = TCONFIGS.get_reduced(MAMBA2)
    before, after = _decode_pools(_tparams(MAMBA2), cfg, list(active))
    for b, a in zip(_ssm(before), _ssm(after)):
        for name in ("state", "conv"):
            for row in range(len(active) + 1):
                same = torch.equal(b[name][row], a[name][row])
                moved = row < len(active) and active[row]
                assert same != moved, (name, row)


def _jamba_without_moe():
    """Reduced Jamba with MLPs in place of its MoE layers: capacity routing
    is per call (a chunk, or a right-padded row's pads, take expert
    capacity the whole prompt would not), so the state contracts below
    hold the Mamba recurrence on a stack whose FFNs see each token alone."""
    cfg = dataclasses.replace(TCONFIGS.get_reduced(JAMBA), num_experts=0)
    return cfg, TLM.init_params(cfg, seed=0, device="cpu")


def test_chunked_prefill_state_equals_one_shot():
    """A 33-token prompt in 16-token chunks through the two-call engine
    (its last chunk ragged) leaves the slot's SSM state and conv tail of
    every Mamba layer where the one-shot contiguous prefill of the same
    prompt leaves them (STaMP off: the chunk is then no transform window),
    within the tolerances of the reference's test."""
    cfg, params = _jamba_without_moe()
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, 33)
    serve = TLM.ServeConfig(stamp=None, kv=QUANT, cache_capacity=64)
    _, dense = TLM.prefill(params, torch.from_numpy(prompt[None]), cfg,
                           serve)
    eng = PagedServingEngine(
        params, cfg, TLM.ServeConfig(stamp=None, kv=QUANT),
        PagedEngineConfig(max_slots=2, prefill_chunk=16, max_seq=96,
                          block_size=16, step_mode="two_call"),
        device="cpu")
    eng.submit(prompt, 1)
    eng.run()
    for got, want in zip(_ssm(eng.pools), _ssm(dense)):
        np.testing.assert_allclose(got["state"][0].numpy(),
                                   want["state"][0].numpy(), rtol=2e-2,
                                   atol=2e-3)
        np.testing.assert_allclose(got["conv"][0].float().numpy(),
                                   want["conv"][0].float().numpy(),
                                   rtol=1e-1, atol=1e-1)


def test_padded_prefill_state_equals_unpadded():
    """Right-padding a prompt from 21 to 32 tokens does not advance the
    Mamba recurrence: ``prefill(last_pos=)`` masks ``dt`` and cuts the
    conv tail at the valid boundary, so state, tail and logits equal the
    unpadded prefill's."""
    cfg, params = _jamba_without_moe()
    prompt = np.random.default_rng(9).integers(0, cfg.vocab_size, 21)
    serve = TLM.ServeConfig(stamp=None, kv=QUANT, cache_capacity=64)
    padded = np.zeros((1, 32), np.int64)
    padded[0, :21] = prompt
    lg_p, cache_p = TLM.prefill(params, torch.from_numpy(padded), cfg,
                                serve, last_pos=torch.tensor([20]))
    lg_u, cache_u = TLM.prefill(params, torch.from_numpy(prompt[None]),
                                cfg, serve)
    for p, u in zip(_ssm(cache_p), _ssm(cache_u)):
        np.testing.assert_allclose(p["state"].numpy(), u["state"].numpy(),
                                   rtol=2e-2, atol=2e-3)
        np.testing.assert_allclose(p["conv"].float().numpy(),
                                   u["conv"].float().numpy(), rtol=2e-2,
                                   atol=2e-3)
    np.testing.assert_allclose(lg_p.numpy(), lg_u.numpy(), rtol=2e-2,
                               atol=2e-3)


def test_pageless_serving_of_more_requests_than_slots():
    """Mamba2 holds no pages (``needs_kv_pages`` off, bytes per slot
    pinned instead): 5 requests through 2 slots all finish, their tokens
    the bucketed engine's."""
    cfg = TCONFIGS.get_reduced(MAMBA2)
    params = _tparams(MAMBA2)
    serve = TLM.ServeConfig(stamp=None,
                            kv=TKV.KVCacheConfig(quantized=False))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n)
               for n in (20, 40, 12, 33, 26)]
    eng = PagedServingEngine(params, cfg, serve, PagedEngineConfig(
        max_slots=2, prefill_chunk=64, max_seq=96, block_size=16),
        device="cpu")
    assert eng.sched.cfg.needs_kv_pages is False
    assert eng.sched.cfg.state_bytes_per_slot == \
        TPKV.ssm_state_bytes_per_slot(eng.pools) > 0
    for p in prompts:
        eng.submit(p, 6)
    paged = {r.uid: r.out_tokens.tolist() for r in eng.run()}
    assert sorted(paged) == [1, 2, 3, 4, 5]
    assert all(len(t) == 6 for t in paged.values())
    buck = BucketedEngine(params, cfg, serve, EngineConfig(
        max_batch=5, bucket=64, max_seq=96), device="cpu")
    for p in prompts:
        buck.submit(p, 6)
    for r in buck.run():
        assert r.out_tokens.tolist() == paged[r.uid], r.uid


def test_prefix_caching_is_off_with_mamba_layers():
    """Asked for prefix caching, an engine over a stack with Mamba layers
    turns it off (a recurrent state must advance through every token);
    a dense stack keeps it."""
    serve = TLM.ServeConfig(stamp=None, kv=QUANT)
    ecfg = PagedEngineConfig(max_slots=2, prefill_chunk=16, max_seq=64,
                             block_size=16, prefix_caching=True)
    for arch, on in ((JAMBA, False), (MAMBA2, False), ("llama3-8b", True)):
        cfg = TCONFIGS.get_reduced(arch)
        eng = PagedServingEngine(_tparams(arch), cfg, serve, ecfg,
                                 device="cpu")
        assert eng.sched.cfg.prefix_caching is on, arch
        assert eng._prefix_on is on, arch


# ---------------------------------------------------------------------------
# the engines against the reference's
# ---------------------------------------------------------------------------


def _drain(engine, prompts) -> dict:
    for p, m in zip(prompts, MAX_NEW):
        engine.submit(p, m)
    return {r.uid: np.asarray(r.out_tokens) for r in engine.run()}


@pytest.fixture(scope="module")
def runs(case):
    """The reference's three engines (from its process) and the port's:
    the unified engine free and teacher-forced to the reference's tokens
    with its own logits kept, the two-call engine and the bucketed
    engine."""
    proc, path = case["engine"]
    log = proc.communicate(timeout=ENGINE_TIMEOUT_S)[0]
    assert proc.returncode == 0, log[-3000:]
    with open(path + ".out", "rb") as f:
        jouts, jsteps = pickle.load(f)
    tcfg, tparams = case["tcfg"], case["tparams"]
    prompts = _prompts(tcfg.vocab_size)
    serve = _serve(TLM, TStampConfig, TKV)

    def paged(**kw):
        return PagedServingEngine(tparams, tcfg, serve,
                                  PagedEngineConfig(**ENGINE, **kw),
                                  device="cpu")

    touts = {"unified": _drain(paged(), prompts),
             "two_call": _drain(paged(step_mode="two_call"), prompts),
             "bucketed": _drain(BucketedEngine(
                 tparams, tcfg, serve, EngineConfig(**BUCKET),
                 device="cpu"), prompts)}
    tsteps = []
    real = TLM.paged_unified_step

    def forced(*args, **kw):
        pf, dec, pools = real(*args, **kw)
        ref = jsteps[len(tsteps)]
        tsteps.append(dict(pf=pf.numpy(), dec=dec.numpy()))
        return torch.tensor(ref["pf"]), torch.tensor(ref["dec"]), pools

    TLM.paged_unified_step = forced
    try:
        forced_out = _drain(paged(), prompts)
    finally:
        TLM.paged_unified_step = real
    return dict(arch=case["arch"], jouts=jouts, touts=touts,
                forced=forced_out, jsteps=jsteps, tsteps=tsteps)


def _forced_rows(runs) -> tuple:
    """(live rows, decisive rows, decisive rows picking another token,
    largest logit difference) of the teacher-forced unified run."""
    live = decisive = missed = 0
    dev = 0.0
    for j, t in zip(runs["jsteps"], runs["tsteps"]):
        rows = [(j["pf"][i], t["pf"][i]) for i in range(len(j["pf"]))
                if j["pf_length"][i] > 0]
        rows += [(j["dec"][s], t["dec"][s]) for s in range(len(j["dec"]))
                 if j["dec_active"][s]]
        for ref, got in rows:
            live += 1
            dev = max(dev, float(np.abs(got - ref).max()))
            top2 = np.sort(ref)[-2:]
            if top2[1] - top2[0] > LOGIT_TOL:
                decisive += 1
                missed += int(got.argmax() != ref.argmax())
    return live, decisive, missed, dev


def test_unified_teacher_forced_rows_match_reference(runs):
    """Teacher-forced to the reference's tokens, the port's unified step
    picks the reference's token on every decisive live row (Mamba2) or on
    all but ``MIX_DECISIVE_MISSED`` (Jamba); Mamba2's live rows' logits
    stay within ``LOGIT_TOL``."""
    for uid, toks in runs["jouts"]["unified"].items():
        np.testing.assert_array_equal(runs["forced"][uid], toks)
    assert len(runs["tsteps"]) == len(runs["jsteps"])
    live, decisive, missed, dev = _forced_rows(runs)
    assert live >= sum(MAX_NEW) and decisive >= 0.5 * live
    if runs["arch"] == MAMBA2:
        assert missed == 0 and dev <= LOGIT_TOL
    else:
        assert missed <= MIX_DECISIVE_MISSED


@pytest.mark.parametrize("mode", ["unified", "two_call", "bucketed"])
def test_engine_tokens_match_reference(runs, mode):
    """Free greedy runs of each engine: every request yields its count;
    Mamba2's tokens are the reference engine's, request by request; Jamba's
    first tokens agree on at least ``MIX_FIRST_TOKENS_AGREE`` of the 4."""
    jout, tout = runs["jouts"][mode], runs["touts"][mode]
    assert set(jout) == set(tout) == {1, 2, 3, 4}
    for uid in jout:
        assert len(tout[uid]) == len(jout[uid]) == MAX_NEW[uid - 1]
    if runs["arch"] == MAMBA2:
        for uid in jout:
            np.testing.assert_array_equal(tout[uid], jout[uid],
                                          err_msg=f"{mode} uid={uid}")
    else:
        first = sum(int(tout[u][0] == jout[u][0]) for u in jout)
        assert first >= MIX_FIRST_TOKENS_AGREE

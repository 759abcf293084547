"""The port's Kimi-K2 (a dense first layer, then 384 experts top-8 of
``moe_d_ff`` 2048 at head_dim 112) against the JAX reference on the CPU,
at its reduced config: the configs field for field and the layer plan, PTQ
(the dense prologue and the expert stacks packed bit for bit), and the
three engines' greedy tokens against the reference's, run in a process of
its own without XLA's excess precision (``test_torch_hybrid.py``'s
runner).  Its MoE layers carry the 8/4-bit mix's remainder, so it keeps
Arctic's allowances (``test_torch_moe.py``: ``MIX_FIRST_TOKENS_AGREE``,
``MIX_DECISIVE_MISSED``) and nothing looser.
"""

import pickle

import jax
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
from repro.models import lm as JLM

from repro_torch import configs as TCONFIGS
from repro_torch.core import ptq as TPTQ
from repro_torch.core.stamp import StampConfig as TStampConfig
from repro_torch.models import lm as TLM
from repro_torch.models.config import LayerSpec
from repro_torch.serving import kvcache as TKV
from repro_torch.serving.engine import (BucketedEngine, EngineConfig,
                                        PagedEngineConfig,
                                        PagedServingEngine)

from test_torch_archs import _init, _shared_fields
from test_torch_hybrid import (BUCKET, ENGINE, ENGINE_TIMEOUT_S, MAX_NEW,
                               _drain, _forced_rows, _prompts, _serve,
                               _start_reference)
from test_torch_moe import MIX_DECISIVE_MISSED, MIX_FIRST_TOKENS_AGREE

ARCH = "kimi-k2-1t-a32b"


@pytest.fixture(autouse=True)
def _reset_reference_switches():
    yield
    JLM.set_fused_cache_attention(False)
    JLM.set_fused_decode_matmul(False)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    jcfg, tcfg = JCONFIGS.get_reduced(ARCH), TCONFIGS.get_reduced(ARCH)
    jparams = _init(jcfg, 0)
    path = str(tmp_path_factory.mktemp("kimi") / ARCH)
    proc = _start_reference(ARCH, jparams, path)
    tparams = TLM.from_jax_params(jax.tree.map(np.asarray, jparams), tcfg)
    yield dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
               engine=(proc, path))
    proc.kill()


def test_configs_and_layer_plan_equal_the_reference():
    """``CONFIG`` and ``reduced()`` equal the reference's field for field
    (61 layers, d 7168, 64 / 8 heads of 112, 384 experts top-8 of 2048, a
    dense first layer) and so do the layer plans; both names resolve."""
    for j, t in ((JCONFIGS.get_config(ARCH), TCONFIGS.get_config(ARCH)),
                 (JCONFIGS.get_reduced(ARCH), TCONFIGS.get_reduced(ARCH))):
        for name, (jv, tv) in _shared_fields(j, t).items():
            assert jv == tv, f"{name}: {jv!r} != {tv!r}"
        for prop in ("resolved_head_dim", "q_dim", "kv_dim", "expert_d_ff",
                     "padded_vocab"):
            assert getattr(j, prop) == getattr(t, prop), prop
        (jpro, jper, jn), (tpro, tper, tn) = j.layer_plan(), t.layer_plan()
        assert jn == tn
        assert [(s.mixer, s.ffn) for s in jpro + jper] == \
            [(s.mixer, s.ffn) for s in tpro + tper]
    full = TCONFIGS.get_config(ARCH)
    assert (full.num_layers, full.d_model, full.resolved_head_dim,
            full.num_experts, full.experts_per_token, full.moe_d_ff) == \
        (61, 7168, 112, 384, 8, 2048)
    assert full.layer_specs()[:2] == (LayerSpec("attn", "mlp"),
                                      LayerSpec("attn", "moe"))
    assert TCONFIGS.canonical(ARCH) == TCONFIGS.canonical("kimi_k2_1t_a32b")


def test_ptq_matches_reference(case):
    """Same calibration batches and weights: the same ``num_hi``, and the
    dense first layer's MLP and every layer's attention and expert stacks
    packed bit for bit."""
    jcfg, tcfg = case["jcfg"], case["tcfg"]
    batches = JDATA.calibration_batches(
        JDATA.DataConfig(vocab_size=jcfg.vocab_size, seq_len=64,
                         global_batch=2), 1)
    jsp, _, jrep = JPTQ.calibrate_and_quantize(case["jparams"], batches,
                                               jcfg)
    tsp, _, trep = TPTQ.calibrate_and_quantize(case["tparams"], batches,
                                               tcfg, device="cpu")
    assert trep.num_hi == jrep.num_hi and trep.avg_bits == jrep.avg_bits
    pro = jsp["prologue"][0]
    for name in ("wq", "wo", "wi_gate", "wo_mlp"):
        for part in ("q", "scale", "zp"):
            np.testing.assert_array_equal(
                tsp["layers"][0][name][part].numpy(),
                np.asarray(pro[name][part]), err_msg=f"0/{name}.{part}")
    for i in range(tcfg.num_layers - 1):
        for name in ("wk", "we_gate", "we_down"):
            for part in ("q", "scale", "zp"):
                np.testing.assert_array_equal(
                    tsp["layers"][1 + i][name][part].numpy(),
                    np.asarray(jsp["period"][0][name][part])[i],
                    err_msg=f"{1 + i}/{name}.{part}")


@pytest.fixture(scope="module")
def runs(case):
    """The reference's three engines (from its process) and the port's,
    with the unified engine also teacher-forced to the reference's
    tokens."""
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
    return dict(jouts=jouts, touts=touts, forced=forced_out, jsteps=jsteps,
                tsteps=tsteps)


def test_unified_teacher_forced_rows_match_reference(runs):
    """Teacher-forced to the reference's tokens, at most
    ``MIX_DECISIVE_MISSED`` decisive live rows pick another token."""
    for uid, toks in runs["jouts"]["unified"].items():
        np.testing.assert_array_equal(runs["forced"][uid], toks)
    live, decisive, missed, _ = _forced_rows(runs)
    assert live >= sum(MAX_NEW) and decisive >= 0.5 * live
    assert missed <= MIX_DECISIVE_MISSED


@pytest.mark.parametrize("mode", ["unified", "two_call", "bucketed"])
def test_engine_tokens_match_reference(runs, mode):
    """Each engine's free greedy run: every request yields its count, and
    the first tokens of at least ``MIX_FIRST_TOKENS_AGREE`` of the 4 are
    the reference engine's."""
    jout, tout = runs["jouts"][mode], runs["touts"][mode]
    assert set(jout) == set(tout) == {1, 2, 3, 4}
    for uid in jout:
        assert len(tout[uid]) == len(jout[uid]) == MAX_NEW[uid - 1]
    assert sum(int(tout[u][0] == jout[u][0]) for u in jout) >= \
        MIX_FIRST_TOKENS_AGREE

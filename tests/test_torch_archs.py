"""The dense architectures the port serves beside llama3-8b — deepseek-7b
(multi-head attention), minicpm-2b (36 heads at full width, tied head),
mistral-nemo-12b (``q_dim != d_model``), qwen2-72b (QKV bias) and
pixart-sigma (the DiT backbone: head_dim 72 at full width, a stub
vocabulary of 8 padded to 128) — against the JAX reference on the CPU,
each at its reduced config.

Both sides run the reference's weights (``from_jax_params``) on the same
numpy-seeded inputs: the reference with its Pallas kernels in interpret
mode, the port with its kernels' plain versions.  Each case holds the
configs field for field, the calibration forward, PTQ and the paged unified
steps (prefill, mixed, all-decode) to the tolerances of
``test_torch_model.py``, and the paged engine's greedy tokens at the 8/4-bit
mix to the reference engine's.  The reference engine runs in a process
of its own with ``--xla_allow_excess_precision=false``, started with each
arch's first test: with XLA's excess precision on, its compiled STaMP round trips keep
bf16 chains in f32 and the 4-bit codes carry the remainder (``ROADMAP.md``
§3, open item 2; here deepseek-7b's second request picks another first
token on a 0.047 race, and prefill rows of mistral-nemo-12b and minicpm-2b
move by 0.8 to 1.0), while without it the first four archs' runs were
measured bit-equal to the port's (pixart-sigma is held by the same tests).
Last, the padded vocabulary: neither side masks
the logits of the pad ids (``padded_vocab`` rounds up to 128), so both can
pick one, and they pick the same.
"""

import dataclasses
import functools
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
from repro.core.stamp import StampConfig as JStampConfig
from repro.data import pipeline as JDATA
from repro.models import lm as JLM

from repro_torch import configs as TCONFIGS
from repro_torch.core import ptq as TPTQ
from repro_torch.core.stamp import StampConfig as TStampConfig
from repro_torch.models import lm as TLM
from repro_torch.serving import kvcache as TKV
from repro_torch.serving.engine import PagedEngineConfig as TEngineConfig
from repro_torch.serving.engine import PagedServingEngine as TEngine

from test_torch_model import LOGIT_TOL, _Seqs, _serve_pair

ARCHS = ("deepseek-7b", "minicpm-2b", "mistral-nemo-12b", "qwen2-72b",
         "pixart-sigma")
PROMPT_LENS = (20, 33, 12)
MAX_NEW = (5, 3, 4)
ENGINE = dict(max_slots=2, prefill_chunk=16, max_seq=64, block_size=16)
ENGINE_TIMEOUT_S = 300        # one arch's reference engine


@pytest.fixture(autouse=True)
def _reset_reference_switches():
    """The reference routes its kernels through process-global switches;
    leave them off for whatever runs next in this process."""
    yield
    JLM.set_fused_cache_attention(False)
    JLM.set_fused_decode_matmul(False)


@functools.lru_cache(maxsize=None)
def _reference_params(arch: str) -> dict:
    """The reduced ``arch``'s reference weights (:func:`_init`, seed 0),
    with QKV biases, which both sides initialise to zero, drawn at random
    so that they move the logits."""
    jcfg = JCONFIGS.get_reduced(arch)
    jparams = _init(jcfg, 0)
    if jcfg.qkv_bias:
        rng = np.random.default_rng(3)
        layers = dict(jparams["period"][0])
        for name in ("bq", "bk", "bv"):
            layers[name] = jnp.asarray(
                rng.standard_normal(layers[name].shape) * 0.5,
                layers[name].dtype)
        jparams = dict(jparams,
                       period=(layers,) + tuple(jparams["period"][1:]))
    return jparams


def _prompts(vocab: int) -> list:
    rng = np.random.default_rng(2)
    return [rng.integers(0, vocab, n) for n in PROMPT_LENS]


# The reference's paged engine on one reduced arch (weights, prompts and
# engine config from the pickle ``argv[2] + ".in"``), every step's logits
# recorded; run in a process of its own so that XLA_FLAGS reaches the
# backend before it starts.
_REFERENCE_ENGINE = """
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
from repro.serving.engine import PagedEngineConfig, PagedServingEngine

arch, path = sys.argv[1], sys.argv[2]
with open(path + ".in", "rb") as f:
    params, prompts, max_new, engine = pickle.load(f)
serve = JLM.ServeConfig(
    stamp=StampConfig(num_hi_tokens=8, execution="fused"),
    kv=JKV.KVCacheConfig(quantized=True, num_hi=16),
    fused_cache_attention=True)
eng = PagedServingEngine(jax.tree.map(jnp.asarray, params),
                         configs.get_reduced(arch), serve,
                         PagedEngineConfig(**engine))
steps = []
step = eng._unified


def record(*args):
    out = step(*args)
    steps.append(dict(pf_length=np.asarray(args[4]),
                      dec_pos=np.asarray(args[9]), pf=np.asarray(out[0]),
                      dec=np.asarray(out[1])))
    return out


eng._unified = record
for p, m in zip(prompts, max_new):
    eng.submit(p, m)
out = {r.uid: np.asarray(r.out_tokens) for r in eng.run()}
with open(path + ".out", "wb") as f:
    pickle.dump((out, steps), f)
"""


def _start_reference_engine(arch: str, path: str) -> subprocess.Popen:
    """The reference engine on ``arch`` without XLA's excess precision, in
    a process of its own writing ``path + ".out"``."""
    with open(path + ".in", "wb") as f:
        pickle.dump((jax.tree.map(np.asarray, _reference_params(arch)),
                     _prompts(JCONFIGS.get_reduced(arch).vocab_size),
                     MAX_NEW, ENGINE), f)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_allow_excess_precision=false").strip()
    return subprocess.Popen(
        [sys.executable, "-c", _REFERENCE_ENGINE, arch, path], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module", params=ARCHS)
def case(request, tmp_path_factory):
    """One reduced arch: both configs, the reference's weights and the
    port's copy of them; its reference engine starts here and runs beside
    the arch's other tests."""
    arch = request.param
    jcfg, tcfg = JCONFIGS.get_reduced(arch), TCONFIGS.get_reduced(arch)
    path = str(tmp_path_factory.mktemp("engine") / arch)
    proc = _start_reference_engine(arch, path)
    jparams = _reference_params(arch)
    tparams = TLM.from_jax_params(jax.tree.map(np.asarray, jparams), tcfg)
    yield dict(arch=arch, jcfg=jcfg, tcfg=tcfg, jparams=jparams,
               tparams=tparams, engine=(proc, path))
    proc.kill()


def _init(jcfg, seed: int) -> dict:
    """The reference's ``init_params``, with a tied head's embedding (std
    0.02, which puts the logits' spread at 0.02·√d, a few hundredths at the
    reduced width: below every tolerance here) rescaled to the untied
    head's std 1/√d, so that logits spread as the other archs' do."""
    jparams = JLM.init_params(jax.random.PRNGKey(seed), jcfg)
    if jcfg.tie_embeddings:
        jparams = dict(jparams, embed=jparams["embed"] / (
            0.02 * np.sqrt(jcfg.d_model)))
    return jparams


def _shared_fields(a, b) -> dict:
    names = {f.name for f in dataclasses.fields(a)} & \
        {f.name for f in dataclasses.fields(b)}
    return {n: (getattr(a, n), getattr(b, n)) for n in sorted(names)}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    """``CONFIG`` and ``reduced()`` equal the reference's on every field
    both dataclasses have (the port's lacks only the families it does not
    serve yet), and the derived widths agree."""
    pairs = [(JCONFIGS.get_config(arch), TCONFIGS.get_config(arch)),
             (JCONFIGS.get_reduced(arch), TCONFIGS.get_reduced(arch))]
    for j, t in pairs:
        fields = _shared_fields(j, t)
        assert {"schedule", "sub_quadratic", "qkv_bias", "head_dim",
                "tie_embeddings", "source"} <= set(fields)
        for name, (jv, tv) in fields.items():
            assert jv == tv, f"{arch}.{name}: {jv!r} != {tv!r}"
        for prop in ("padded_vocab", "resolved_head_dim", "q_dim", "kv_dim"):
            assert getattr(j, prop) == getattr(t, prop), prop
    assert TCONFIGS.canonical(arch) == JCONFIGS.canonical(arch)


def test_model_hidden_matches_reference(case):
    """The calibration forward (bf16, no quantizer) within 5e-2, as in
    ``test_torch_model.py``."""
    tokens = np.random.default_rng(0).integers(
        0, case["jcfg"].vocab_size, (2, 24)).astype(np.int32)
    jx, _, _ = JLM.model_hidden(case["jparams"],
                                {"tokens": jnp.asarray(tokens)},
                                case["jcfg"], mode="train", policy=None,
                                remat=False)
    tx = TLM.model_hidden(case["tparams"], torch.from_numpy(tokens),
                          case["tcfg"])
    np.testing.assert_allclose(tx.float().numpy(),
                               np.asarray(jx, np.float32), atol=5e-2)


def test_ptq_matches_reference(case):
    """Same calibration batches, same weights: the same ``num_hi`` and
    ``avg_bits`` and bit-identical packed int4 weights at every linear
    site (QKV bias and the ``q_dim``-wide out-proj included)."""
    jcfg, tcfg = case["jcfg"], case["tcfg"]
    batches = JDATA.calibration_batches(
        JDATA.DataConfig(vocab_size=jcfg.vocab_size, seq_len=64,
                         global_batch=2), 2)
    jsp, jserve, jrep = JPTQ.calibrate_and_quantize(case["jparams"], batches,
                                                    jcfg)
    tsp, tserve, trep = TPTQ.calibrate_and_quantize(case["tparams"], batches,
                                                    tcfg, device="cpu")
    assert trep.num_hi == jrep.num_hi
    assert trep.avg_bits == jrep.avg_bits
    assert abs(trep.toeplitz_fraction - jrep.toeplitz_fraction) < 1e-2
    assert tserve.kv.num_hi == jserve.kv.num_hi == jrep.num_hi
    names = ("wq", "wk", "wv", "wo", "wi_gate", "wi_up", "wo_mlp")
    for name in names:
        jw = jsp["period"][0][name]
        for i in range(tcfg.num_layers):
            for part in ("q", "scale", "zp"):
                np.testing.assert_array_equal(
                    tsp["layers"][i][name][part].numpy(),
                    np.asarray(jw[part])[i], err_msg=f"{name}.{part}")
    if tcfg.qkv_bias:
        for name in ("bq", "bk", "bv"):
            for i in range(tcfg.num_layers):
                np.testing.assert_array_equal(
                    tsp["layers"][i][name].float().numpy(),
                    np.asarray(jsp["period"][0][name], np.float32)[i])


def test_paged_steps_match_reference(case):
    """A prefill step (two chunks, one padded), a mixed step (a
    continuation chunk beside a decode) and an all-decode step on one pair
    of caches at page size 4, the steps of ``test_torch_model.py``: live
    rows' logits within ``LOGIT_TOL``."""
    jcfg, tcfg = case["jcfg"], case["tcfg"]
    stamp_j = JStampConfig(num_hi_tokens=8, execution="fused")
    stamp_t = TStampConfig(num_hi_tokens=8, execution="fused")
    jprep = JLM.prepare_fused_weights(case["jparams"], stamp_j)
    tprep = TLM.prepare_fused_weights(case["tparams"], stamp_t)
    seqs = _Seqs(4)
    jserve, tserve = _serve_pair(seqs)
    rng = np.random.default_rng(4)
    prompt_a = rng.integers(0, jcfg.vocab_size, 20).astype(np.int32)
    prompt_b = rng.integers(0, jcfg.vocab_size, 11).astype(np.int32)
    steps = [
        seqs.step([("A", 0, prompt_a[:16]), ("B", 0, prompt_b)], {}),
        seqs.step([("A", 16, prompt_a[16:])], {1: ("B", 11, 5)}),
        seqs.step([], {0: ("A", 20, 7), 1: ("B", 12, 9)}),
    ]
    jpools = JLM.init_paged_cache(jcfg, jserve.paged)
    tpools = TLM.init_paged_cache(tcfg, tserve.paged, device="cpu")
    for n, st in enumerate(steps):
        jpf, jdec, jpools = JLM.paged_unified_step(
            jprep, jpools, *(jnp.asarray(st[k]) for k in (
                "pf_tokens", "pf_start", "pf_length")),
            jnp.asarray(st["pf_start"] == 0), jnp.asarray(st["pf_last_index"]),
            jnp.asarray(st["slots"]), jnp.asarray(st["dec_tokens"]),
            jnp.asarray(st["dec_positions"]), jnp.asarray(st["active"]),
            *(jnp.asarray(st[k]) for k in ("hi_table", "lo_table", "pages",
                                           "offsets", "is_hi")),
            jcfg, jserve)
        tpf, tdec, tpools = TLM.paged_unified_step(
            tprep, tpools, *(torch.from_numpy(st[k]) for k in (
                "pf_tokens", "pf_start", "pf_length", "pf_last_index",
                "dec_tokens", "dec_positions", "hi_table", "lo_table",
                "pages", "offsets", "is_hi")), tcfg, tserve)
        assert tpf.shape == jpf.shape and tdec.shape == jdec.shape
        assert tdec.shape[-1] == tcfg.padded_vocab
        np.testing.assert_allclose(tpf.numpy(), np.asarray(jpf),
                                   atol=LOGIT_TOL, err_msg=f"step {n}")
        live = st["active"]
        np.testing.assert_allclose(tdec.numpy()[live],
                                   np.asarray(jdec)[live], atol=LOGIT_TOL,
                                   err_msg=f"step {n}")


def _drain(engine, prompts) -> dict:
    for p, m in zip(prompts, MAX_NEW):
        engine.submit(p, m)
    return {r.uid: np.asarray(r.out_tokens) for r in engine.run()}


@pytest.fixture(scope="module")
def runs(case):
    """The reference engine's greedy run with every step's logits (from its
    process), the port's free greedy run, and the port's run teacher-forced
    to the reference's tokens with its own logits kept (the scheme of
    ``test_torch_engine.py``, on 3 requests and 2 slots)."""
    proc, path = case["engine"]
    log = proc.communicate(timeout=ENGINE_TIMEOUT_S)[0]
    assert proc.returncode == 0, log[-3000:]
    with open(path + ".out", "rb") as f:
        jout, jsteps = pickle.load(f)
    prompts = _prompts(case["tcfg"].vocab_size)

    def engine():
        serve = TLM.ServeConfig(
            stamp=TStampConfig(num_hi_tokens=8, execution="fused"),
            kv=TKV.KVCacheConfig(quantized=True, num_hi=16),
            fused_cache_attention=True)
        return TEngine(case["tparams"], case["tcfg"], serve,
                       TEngineConfig(**ENGINE), device="cpu")

    tout = _drain(engine(), prompts)
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
    return dict(jout=jout, tout=tout, forced=forced_out, jsteps=jsteps,
                tsteps=tsteps)


def test_first_tokens_match_reference_engine(runs):
    """Free greedy runs: every request yields its full count, and its
    first token, and every later one, is the reference engine's."""
    jout, tout = runs["jout"], runs["tout"]
    assert set(jout) == set(tout) == {1, 2, 3}
    for uid in jout:
        assert len(tout[uid]) == len(jout[uid]) == MAX_NEW[uid - 1]
        assert tout[uid][0] == jout[uid][0], f"uid={uid}"
        np.testing.assert_array_equal(tout[uid], jout[uid])


def test_teacher_forced_argmax_matches_reference_engine(runs):
    """Teacher-forced to the reference's tokens, the port's greedy pick is
    the reference's on every live row (non-dummy chunk rows, occupied
    decode slots) whose reference top-1/top-2 margin exceeds ``LOGIT_TOL``
    (the rule of ``test_torch_engine.py``), and every live row's logits
    are within ``LOGIT_TOL`` of the reference's (measured: equal)."""
    for uid, toks in runs["jout"].items():       # the forcing took hold
        np.testing.assert_array_equal(runs["forced"][uid], toks)
    jsteps, tsteps = runs["jsteps"], runs["tsteps"]
    assert len(tsteps) == len(jsteps)
    live = 0
    for j, t in zip(jsteps, tsteps):
        rows = [(j["pf"][i], t["pf"][i]) for i in range(len(j["pf"]))
                if j["pf_length"][i] > 0]
        rows += [(j["dec"][s], t["dec"][s]) for s in range(len(j["dec"]))
                 if j["dec_pos"][s] > 0]
        for ref, got in rows:
            live += 1
            assert float(np.abs(got - ref).max()) <= LOGIT_TOL
            top2 = np.sort(ref)[-2:]
            if top2[1] - top2[0] > LOGIT_TOL:
                assert got.argmax() == ref.argmax()
    assert live >= sum(MAX_NEW)


def test_padded_vocabulary_is_not_masked_on_either_side():
    """A reduced deepseek-7b at a vocabulary of 500, padded to 512 (an
    untied head: a tied one ranks the input token's own id first, never a
    pad id): both sides' logits span all 512 columns, the pad ids' logits are
    finite (neither side masks them), and the greedy pick — the argmax over
    the padded columns, as both engines take it — is the same on every row
    whose top-1/top-2 margin exceeds ``LOGIT_TOL``, pad ids included: some
    rows pick one on both sides."""
    jcfg = dataclasses.replace(JCONFIGS.get_reduced("deepseek-7b"),
                               vocab_size=500)
    tcfg = dataclasses.replace(TCONFIGS.get_reduced("deepseek-7b"),
                               vocab_size=500)
    assert jcfg.padded_vocab == tcfg.padded_vocab == 512
    jparams = _init(jcfg, 1)
    tparams = TLM.from_jax_params(jax.tree.map(np.asarray, jparams), tcfg)
    tokens = np.random.default_rng(5).integers(0, 500, (4, 256)).astype(
        np.int32)
    jx, _, _ = JLM.model_hidden(jparams, {"tokens": jnp.asarray(tokens)},
                                jcfg, mode="train", policy=None, remat=False)
    jl = np.asarray(JLM._linear(jx, JLM._head_weight(jparams)),
                    np.float32).reshape(-1, 512)
    tx = TLM.model_hidden(tparams, torch.from_numpy(tokens), tcfg)
    tl = TLM._linear(tx, TLM._head_weight(tparams)).float().numpy() \
        .reshape(-1, 512)
    assert np.isfinite(jl).all() and np.isfinite(tl).all()
    top2 = np.sort(jl, axis=-1)[:, -2:]
    decisive = top2[:, 1] - top2[:, 0] > LOGIT_TOL
    assert decisive.mean() >= 0.5
    np.testing.assert_array_equal(tl.argmax(-1)[decisive],
                                  jl.argmax(-1)[decisive])
    in_pad = decisive & (jl.argmax(-1) >= 500)
    assert in_pad.sum() >= 1

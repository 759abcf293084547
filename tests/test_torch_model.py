"""The port's model against the JAX reference on the CPU: weights carried
across, the calibration forward, PTQ, fused weight preparation, and the
paged unified / decode steps on the same pools and block tables.

Both sides compute with the same weights: the reference's
``init_params`` tree goes to the port through ``from_jax_params``.  The
steps run in bf16 on both sides (the reference's Pallas kernels in
interpret mode, the port's kernels' plain versions).  The integer products
and the quantizer arithmetic agree bit for bit, but XLA's and PyTorch's
``exp`` and matmul summation orders differ in the last f32 bit; where that
moves a bf16 rounding, a downstream quantizer code can move by one step.
The step test therefore quantizes chunk activations at 8 bits (a code step
1/17 of a 4-bit one) and holds logits within ``LOGIT_TOL = 0.1``, a tenth
of their spread: a wrong mask, page, transform or scale moves them by
O(1).  The main path's 8/4-bit mix is held end to end by the engine test's
teacher-forced rule and row by row by the kernel tests.
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

from repro.core import ptq as JPTQ
from repro.core.stamp import StampConfig as JStampConfig
from repro.data import pipeline as JDATA
from repro.models import lm as JLM
from repro.models.config import ModelConfig as JModelConfig
from repro.serving import kvcache as JKV
from repro.serving import paged_kvcache as JPKV

from repro_torch.core import ptq as TPTQ
from repro_torch.core.stamp import StampConfig as TStampConfig
from repro_torch.data import pipeline as TDATA
from repro_torch.models import lm as TLM
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.serving import kvcache as TKV
from repro_torch.serving import paged_kvcache as TPKV

LOGIT_TOL = 0.1
DIMS = dict(name="unified-test", family="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128)
JCFG, TCFG = JModelConfig(**DIMS), TModelConfig(**DIMS)
NUM_HI, C_LEN, SLOTS = 16, 16, 3


@pytest.fixture(scope="module")
def jparams():
    return JLM.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def tparams(jparams):
    return TLM.from_jax_params(jax.tree.map(np.asarray, jparams), TCFG)


@pytest.fixture(autouse=True)
def _reset_reference_switches():
    """The reference routes its kernels through process-global switches;
    leave them off for whatever runs next in this process."""
    yield
    JLM.set_fused_cache_attention(False)
    JLM.set_fused_decode_matmul(False)


# ---------------------------------------------------------------------------
# weights and the calibration forward
# ---------------------------------------------------------------------------


def test_from_jax_params_unrolls_the_period_stack(jparams, tparams):
    own = TLM.init_params(TCFG, seed=0, device="cpu")
    assert set(own) == set(tparams) == {"embed", "final_norm", "head",
                                        "layers"}
    assert len(tparams["layers"]) == len(own["layers"]) == 2
    for i, layer in enumerate(tparams["layers"]):
        assert {k: v.shape for k, v in layer.items()} == \
            {k: v.shape for k, v in own["layers"][i].items()}
        for k, v in layer.items():
            np.testing.assert_array_equal(
                v.numpy(), np.asarray(jparams["period"][0][k])[i])
    np.testing.assert_array_equal(tparams["head"].numpy(),
                                  np.asarray(jparams["head"]))


def test_tied_head_reads_embed_transposed(jparams):
    cfg = TModelConfig(**{**DIMS, "tie_embeddings": True})
    tree = {k: np.asarray(v) for k, v in jparams.items()
            if k not in ("head", "period")}
    tree["period"] = jax.tree.map(np.asarray, jparams["period"])
    params = TLM.from_jax_params(tree, cfg)
    assert "head" not in params
    assert torch.equal(TLM._head_weight(params), params["embed"].T)


def test_model_hidden_matches_reference(jparams, tparams):
    """The calibration forward (bf16, no quantizer) within 5e-2: a few
    bf16 steps of the normed hidden state."""
    tokens = np.random.default_rng(0).integers(0, 128, (2, 24)).astype(
        np.int32)
    jx, _, _ = JLM.model_hidden(jparams, {"tokens": jnp.asarray(tokens)},
                                JCFG, mode="train", policy=None, remat=False)
    tx = TLM.model_hidden(tparams, torch.from_numpy(tokens), TCFG)
    np.testing.assert_allclose(tx.float().numpy(),
                               np.asarray(jx, np.float32), atol=5e-2)


# ---------------------------------------------------------------------------
# PTQ and weight preparation
# ---------------------------------------------------------------------------


def test_calibration_batches_match_reference():
    jd = JDATA.DataConfig(vocab_size=128, seq_len=32, global_batch=2)
    td = TDATA.DataConfig(vocab_size=128, seq_len=32, global_batch=2)
    for a, b in zip(JDATA.calibration_batches(jd, 3),
                    TDATA.calibration_batches(td, 3)):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_ptq_matches_reference(jparams, tparams):
    """Same calibration batches, same weights: the same ``num_hi`` and
    ``avg_bits``, and bit-identical packed int4 weights."""
    batches = JDATA.calibration_batches(
        JDATA.DataConfig(vocab_size=128, seq_len=64, global_batch=2), 2)
    jsp, jserve, jrep = JPTQ.calibrate_and_quantize(jparams, batches, JCFG)
    tsp, tserve, trep = TPTQ.calibrate_and_quantize(tparams, batches, TCFG,
                                                    device="cpu")
    assert trep.num_hi == jrep.num_hi
    assert trep.avg_bits == jrep.avg_bits
    assert abs(trep.toeplitz_fraction - jrep.toeplitz_fraction) < 1e-2
    assert tserve.kv.num_hi == jserve.kv.num_hi == jrep.num_hi
    assert tserve.stamp.num_hi_tokens == jserve.stamp.num_hi_tokens
    for name in ("wq", "wi_gate", "wo_mlp"):
        jw = jsp["period"][0][name]
        for i in range(2):
            for part in ("q", "scale", "zp"):
                np.testing.assert_array_equal(
                    tsp["layers"][i][name][part].numpy(),
                    np.asarray(jw[part])[i], err_msg=f"{name}.{part}")


def test_prepare_fused_weights_matches_reference(jparams, tparams):
    """Merged ``wqkv`` and per-site int8 buffers: codes, scales and zero
    points bit-identical; every code tensor contiguous for the kernels."""
    stamp_j = JStampConfig(num_hi_tokens=8, execution="fused")
    stamp_t = TStampConfig(num_hi_tokens=8, execution="fused")
    jpack = JLM.quantize_weights_for_serving(
        jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams), 4)
    jprep = JLM.prepare_fused_weights(jpack, stamp_j)["period"][0]
    tpack = dict(tparams, layers=[
        TLM.quantize_weights_for_serving(
            {k: v.to(torch.bfloat16) for k, v in layer.items()}, 4)
        for layer in tparams["layers"]])
    tprep = TLM.prepare_fused_weights(tpack, stamp_t)["layers"]
    for site in ("wqkv", "wo", "wi_gate", "wi_up", "wo_mlp"):
        for i in range(2):
            for part in ("iq", "isw", "izw"):
                got = tprep[i][site][part]
                assert got.is_contiguous()
                np.testing.assert_array_equal(
                    got.numpy(), np.asarray(jprep[site][part])[i],
                    err_msg=f"{site}.{part}")


# ---------------------------------------------------------------------------
# the paged steps on the same pools and tables
# ---------------------------------------------------------------------------


class _Seqs:
    """Two sequences with hand-assigned pages: A (prompt 20) and B (prompt
    11); hi pages first, then lo pages, page 0 left as the null page."""

    def __init__(self, block_size: int):
        self.bs = block_size
        nh = NUM_HI // block_size
        self.nl = -(-(32 - NUM_HI) // block_size)
        self.hi = {"A": list(range(1, 1 + nh)),
                   "B": list(range(1 + nh, 1 + 2 * nh))}
        self.lo = {"A": list(range(1, 1 + self.nl)),
                   "B": list(range(1 + self.nl, 1 + 2 * self.nl))}
        self.n_hi_blocks, self.n_lo_blocks = 1 + 2 * nh, 1 + 2 * self.nl
        self.tcfg = TPKV.PagedCacheConfig(
            block_size=block_size, num_lo_blocks=self.n_lo_blocks,
            num_hi_blocks=self.n_hi_blocks, max_blocks_per_seq=self.nl,
            quant=TKV.KVCacheConfig(quantized=True, num_hi=NUM_HI))

    def target(self, seq: str, pos: int) -> tuple:
        is_hi, idx, off = TPKV.token_page_index(pos, self.tcfg)
        return (self.hi if is_hi else self.lo)[seq][idx], off, is_hi

    def step(self, prefills, decodes) -> dict:
        """``prefills``: [(seq, start, tokens)]; ``decodes``: {slot: (seq,
        pos, token)}.  The unified step's host-built arrays, in numpy."""
        n_pf = len(prefills)
        nh = len(self.hi["A"])
        ht = np.zeros((n_pf + SLOTS, nh), np.int32)
        lt = np.zeros((n_pf + SLOTS, self.nl), np.int32)
        tokens = np.zeros((n_pf, C_LEN), np.int32)
        start, length, last = (np.zeros(n_pf, np.int32) for _ in range(3))
        pages = np.zeros(n_pf * C_LEN + SLOTS, np.int32)
        offs = np.zeros_like(pages)
        ishi = np.zeros(pages.shape, bool)
        for i, (seq, s0, toks) in enumerate(prefills):
            tokens[i, :len(toks)] = toks
            start[i], length[i], last[i] = s0, s0 + len(toks), len(toks) - 1
            ht[i], lt[i] = self.hi[seq], self.lo[seq]
            for t in range(len(toks)):
                pages[i * C_LEN + t], offs[i * C_LEN + t], \
                    ishi[i * C_LEN + t] = self.target(seq, s0 + t)
        dec_tok = np.zeros(SLOTS, np.int32)
        dec_pos = np.zeros(SLOTS, np.int32)
        active = np.zeros(SLOTS, bool)
        for slot, (seq, pos, tok) in decodes.items():
            dec_tok[slot], dec_pos[slot], active[slot] = tok, pos, True
            ht[n_pf + slot], lt[n_pf + slot] = self.hi[seq], self.lo[seq]
            j = n_pf * C_LEN + slot
            pages[j], offs[j], ishi[j] = self.target(seq, pos)
        return dict(pf_tokens=tokens, pf_start=start, pf_length=length,
                    pf_last_index=last, dec_tokens=dec_tok,
                    dec_positions=dec_pos, hi_table=ht, lo_table=lt,
                    pages=pages, offsets=offs, is_hi=ishi, active=active,
                    slots=np.array([{"A": 0, "B": 1}[p[0]]
                                    for p in prefills], np.int32))


def _serve_pair(seqs: _Seqs):
    kv_j = JKV.KVCacheConfig(quantized=True, num_hi=NUM_HI)
    jcfg = JPKV.PagedCacheConfig(
        block_size=seqs.bs, num_lo_blocks=seqs.n_lo_blocks,
        num_hi_blocks=seqs.n_hi_blocks, max_blocks_per_seq=seqs.nl,
        quant=kv_j)
    jserve = JLM.ServeConfig(
        stamp=JStampConfig(num_hi_tokens=C_LEN, execution="fused"), kv=kv_j,
        fused_cache_attention=True, fused_decode_matmul=True, paged=jcfg)
    tserve = TLM.ServeConfig(
        stamp=TStampConfig(num_hi_tokens=C_LEN, execution="fused"),
        kv=seqs.tcfg.quant, fused_cache_attention=True,
        fused_decode_matmul=True, paged=seqs.tcfg)
    return jserve, tserve


@pytest.fixture(scope="module")
def prepared(jparams, tparams):
    stamp_j = JStampConfig(num_hi_tokens=8, execution="fused")
    stamp_t = TStampConfig(num_hi_tokens=8, execution="fused")
    return (JLM.prepare_fused_weights(jparams, stamp_j),
            TLM.prepare_fused_weights(tparams, stamp_t))


@pytest.mark.parametrize("block_size", [4, 16])
def test_paged_steps_match_reference(prepared, block_size):
    """Three steps on one pair of caches: two prefill chunks (one padded),
    a mixed step (a continuation chunk with an odd valid length beside a
    decode), and an all-decode step (``n_pf = 0`` → the decode step).
    Logits of the live rows within ``LOGIT_TOL``; every chunk row is an
    8-bit row (``num_hi_tokens = C``)."""
    jprep, tprep = prepared
    seqs = _Seqs(block_size)
    jserve, tserve = _serve_pair(seqs)
    rng = np.random.default_rng(block_size)
    prompt_a = rng.integers(0, 128, 20).astype(np.int32)
    prompt_b = rng.integers(0, 128, 11).astype(np.int32)
    steps = [
        seqs.step([("A", 0, prompt_a[:16]), ("B", 0, prompt_b)], {}),
        seqs.step([("A", 16, prompt_a[16:])], {1: ("B", 11, 5)}),
        seqs.step([], {0: ("A", 20, 7), 1: ("B", 12, 9)}),
    ]
    jpools = JLM.init_paged_cache(JCFG, jserve.paged)
    tpools = TLM.init_paged_cache(TCFG, tserve.paged, device="cpu")
    for n, st in enumerate(steps):
        jpf, jdec, jpools = JLM.paged_unified_step(
            jprep, jpools, *(jnp.asarray(st[k]) for k in (
                "pf_tokens", "pf_start", "pf_length")),
            jnp.asarray(st["pf_start"] == 0), jnp.asarray(st["pf_last_index"]),
            jnp.asarray(st["slots"]), jnp.asarray(st["dec_tokens"]),
            jnp.asarray(st["dec_positions"]), jnp.asarray(st["active"]),
            *(jnp.asarray(st[k]) for k in ("hi_table", "lo_table", "pages",
                                           "offsets", "is_hi")),
            JCFG, jserve)
        tpf, tdec, tpools = TLM.paged_unified_step(
            tprep, tpools, *(torch.from_numpy(st[k]) for k in (
                "pf_tokens", "pf_start", "pf_length", "pf_last_index",
                "dec_tokens", "dec_positions", "hi_table", "lo_table",
                "pages", "offsets", "is_hi")), TCFG, tserve)
        assert tpf.shape == jpf.shape and tdec.shape == jdec.shape
        np.testing.assert_allclose(tpf.numpy(), np.asarray(jpf),
                                   atol=LOGIT_TOL, err_msg=f"step {n}")
        live = st["active"]
        np.testing.assert_allclose(tdec.numpy()[live],
                                   np.asarray(jdec)[live], atol=LOGIT_TOL,
                                   err_msg=f"step {n}")


def test_decode_shapes_route_to_the_decode_matmul():
    """The dispatch rule: decode-shaped ``(S, 1, d)`` input over prepared
    weights takes the decode kernel; chunk rows never do."""
    from repro_torch.core.stamp import prepare_linear
    p = prepare_linear(torch.randn(16, 8))
    w = {"iq": p.qw, "isw": p.sw, "izw": p.zw, "iqsum": p.qw_sum}
    calls = []
    orig = TLM.stamp_decode_matmul
    TLM.stamp_decode_matmul = lambda *a, **k: calls.append(1) or orig(*a,
                                                                        **k)
    try:
        TLM._linear(torch.randn(3, 1, 16), w, decode_matmul=True)
        TLM._linear(torch.randn(3, 4, 16), w, decode_matmul=True)
        TLM._linear(torch.randn(3, 1, 16), w, decode_matmul=False)
    finally:
        TLM.stamp_decode_matmul = orig
    assert len(calls) == 1

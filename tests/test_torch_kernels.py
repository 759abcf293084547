"""The port's kernels against the JAX reference's Pallas kernels.

On the CPU every wrapper of ``repro_torch.kernels`` runs its plain PyTorch
version, so these tests hold that arithmetic against the Pallas kernels
run in interpret mode (as the JAX suite runs them here) on the same numpy
inputs: the fused STaMP linear and dual linear, the decode matmul, and the
ragged / decode paged attention.  Float outputs agree within ``rtol=1e-5``:
the integer products are exact on both sides and the f32 epilogues and
transforms take the same operation order, so only the softmax and
matmul summation orders differ.

The CUDA kernels themselves are held against these plain versions in
``test_torch_cuda.py`` (on a card) and in ``chip_smoke.py``.
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

from repro.core import stamp as JS
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro.kernels import stamp_matmul as JSM
from repro.kernels.paged_attention import (paged_decode_attention,
                                           paged_ragged_attention)

from repro_torch.core import stamp as TS
from repro_torch.kernels import decode_matmul as TDM
from repro_torch.kernels import ops as TO
from repro_torch.kernels import paged_attention as TPA
from repro_torch.kernels import ref as TR
from repro_torch.kernels import stamp_matmul as TSM
from repro_torch.serving import kvcache as TKV
from test_torch_cuda import paged_pools

RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _weights(rng, k, n):
    w = rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k)
    jp = JS.prepare_linear(jnp.asarray(w))
    tp = TS.prepare_linear(_t(w))
    return jp, tp


# ---------------------------------------------------------------------------
# rows 1 and 2: fused STaMP linear and dual linear (K1 → K2 plain chain)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transform", ["dwt", "wht", "none"])
@pytest.mark.parametrize("seq,num_hi", [(7, 4), (16, 4), (33, 8), (5, 64)])
def test_stamp_quant_matmul_matches_pallas(transform, seq, num_hi):
    """Odd and power-of-two spans, ``num_hi >= seq`` included, with a bias:
    the port's K1 → K2 chain against ``stamp_quant_matmul_pallas``."""
    rng = np.random.default_rng(seq * 7 + num_hi)
    x = (rng.standard_normal((2, seq, 48)) * 2).astype(np.float32)
    bias = rng.standard_normal((40,)).astype(np.float32)
    jp, tp = _weights(rng, 48, 40)
    kw = dict(transform=transform, levels=3, skip_first=True, num_hi=num_hi,
              hi_bits=8, lo_bits=4)
    ja = JO.stamp_quant_matmul(jnp.asarray(x), jp.qw, jp.sw, jp.zw,
                               jnp.asarray(bias), out_dtype=jnp.float32,
                               interpret=True, **kw)
    ta = TO.stamp_quant_matmul(_t(x), tp.qw, tp.sw, tp.zw, tp.qw_sum,
                               _t(bias), out_dtype=torch.float32, **kw)
    assert ta.shape == (2, seq, 40)
    assert _rel(ja, ta.numpy()) <= RTOL


def test_stamp_quant_matmul_head_split_input():
    """The out-proj site: the reference takes the raw head-split (b, s, nh,
    hd) input; the port hands K1 its contiguous (b, s, nh·hd) view."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 9, 4, 8)).astype(np.float32)
    jp, tp = _weights(rng, 32, 24)
    kw = dict(transform="dwt", levels=2, skip_first=True, num_hi=4)
    ja = JO.stamp_quant_matmul(jnp.asarray(x), jp.qw, jp.sw, jp.zw,
                               out_dtype=jnp.float32, interpret=True, **kw)
    ta = TO.stamp_quant_matmul(_t(x).reshape(2, 9, 32), tp.qw, tp.sw, tp.zw,
                               tp.qw_sum, out_dtype=torch.float32, **kw)
    assert _rel(ja, ta.numpy()) <= RTOL


@pytest.mark.parametrize("transform", ["dwt", "wht"])
@pytest.mark.parametrize("seq", [7, 16, 33])
def test_stamp_quant_dual_matmul_matches_pallas(transform, seq):
    """ONE transform + quantize feeding gate and up, ``silu(g)·u``."""
    rng = np.random.default_rng(seq + 100)
    x = rng.standard_normal((2, seq, 32)).astype(np.float32)
    jg, tg = _weights(rng, 32, 24)
    ju, tu = _weights(rng, 32, 24)
    kw = dict(transform=transform, levels=3, skip_first=True, num_hi=4)
    ja = JO.stamp_quant_dual_matmul(jnp.asarray(x), jg.qw, jg.sw, jg.zw,
                                    ju.qw, ju.sw, ju.zw,
                                    out_dtype=jnp.float32, interpret=True,
                                    **kw)
    ta = TO.stamp_quant_dual_matmul(_t(x), tg.qw, tg.sw, tg.zw, tg.qw_sum,
                                    tu.qw, tu.sw, tu.zw, tu.qw_sum,
                                    out_dtype=torch.float32, **kw)
    assert _rel(ja, ta.numpy()) <= RTOL


def test_unfused_oracles_match_reference_oracles():
    """``kernels/ref.py`` (float fake quant, dequantized weights) against
    the reference's oracles of rows 1, 2 and 4."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    jg, tg = _weights(rng, 32, 24)
    ju, tu = _weights(rng, 32, 24)
    kw = dict(transform="dwt", levels=3, skip_first=True, num_hi=4)
    assert _rel(JR.stamp_quant_matmul_ref(jnp.asarray(x), jg.qw, jg.sw,
                                          jg.zw, **kw),
                TR.stamp_quant_matmul_ref(_t(x), tg.qw, tg.sw, tg.zw,
                                          **kw).numpy()) <= RTOL
    assert _rel(JR.stamp_quant_dual_matmul_ref(jnp.asarray(x), jg.qw, jg.sw,
                                               jg.zw, ju.qw, ju.sw, ju.zw,
                                               **kw),
                TR.stamp_quant_dual_matmul_ref(_t(x), tg.qw, tg.sw, tg.zw,
                                               tu.qw, tu.sw, tu.zw,
                                               **kw).numpy()) <= RTOL
    xd = rng.standard_normal((5, 32)).astype(np.float32)
    assert _rel(JR.stamp_decode_matmul_ref(jnp.asarray(xd), jg.qw, jg.sw,
                                           jg.zw),
                TR.stamp_decode_matmul_ref(_t(xd), tg.qw, tg.sw,
                                           tg.zw).numpy()) <= RTOL


# ---------------------------------------------------------------------------
# the integer GEMM: pinned to exact int32 accumulation
# ---------------------------------------------------------------------------


def test_int_gemm_accumulates_exactly_in_int32():
    """Products past 2^24 (where an f32 accumulator would round) come out
    exact and int32; the reference's contract checker cannot prove its own
    int32 accumulation on jax 0.9.0, so the port pins it here."""
    k = 2048
    qx = torch.full((3, k), -128, dtype=torch.int8)
    qx[1] = 127
    qx[2, ::2] = 1
    qw = torch.full((k, 5), -128, dtype=torch.int8)
    qw[:, 1] = 127
    qw[7, 2] = 3
    acc = TSM.int_matmul(qx, qw)
    assert acc.dtype == torch.int32
    exact = qx.numpy().astype(np.int64) @ qw.numpy().astype(np.int64)
    assert exact.max() > 2 ** 24
    np.testing.assert_array_equal(acc.numpy(), exact)
    with pytest.raises(ValueError):
        TSM.int_matmul(torch.zeros((1, 1 << 17), dtype=torch.int8),
                       torch.zeros((1 << 17, 1), dtype=torch.int8))


def test_int_gemm_epilogue_matches_reference_order():
    """The zero-point epilogue casts the int32 accumulator to f32 first and
    corrects in the reference's order: equal to ``_int_gemm``."""
    rng = np.random.default_rng(13)
    k = 4096
    qx = rng.integers(-128, 128, (6, k)).astype(np.int8)
    qw = rng.integers(-128, 128, (k, 8)).astype(np.int8)
    sx = rng.uniform(0.01, 0.1, (6, 1)).astype(np.float32)
    zx = rng.integers(-128, 128, (6, 1)).astype(np.float32)
    sw = rng.uniform(0.01, 0.1, (1, 8)).astype(np.float32)
    zw = rng.integers(-128, 128, (1, 8)).astype(np.float32)
    ja = JSM._int_gemm(jnp.asarray(qx), jnp.asarray(sx), jnp.asarray(zx),
                       jnp.asarray(qw), jnp.asarray(sw), jnp.asarray(zw),
                       k_total=k)
    tqx, tqw = _t(qx), _t(qw)
    ta = TSM._epilogue(TSM.int_matmul(tqx, tqw), _t(sx[:, 0]), _t(zx[:, 0]),
                       _t(sw), _t(zw), tqx.sum(dim=1, dtype=torch.int32),
                       tqw.sum(dim=0, dtype=torch.int32), k)
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())


# ---------------------------------------------------------------------------
# row 4: decode matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", [1, 3, 8])
def test_decode_matmul_matches_pallas(rows):
    rng = np.random.default_rng(rows)
    x = (rng.standard_normal((rows, 64)) * 3).astype(np.float32)
    bias = rng.standard_normal((48,)).astype(np.float32)
    jp, tp = _weights(rng, 64, 48)
    ja = JO.stamp_decode_matmul(jnp.asarray(x), jp.qw, jp.sw, jp.zw,
                                jnp.asarray(bias), out_dtype=jnp.float32,
                                interpret=True)
    ta = TDM.stamp_decode_matmul(_t(x), tp.qw, tp.sw, tp.zw, tp.qw_sum,
                                 _t(bias))
    assert _rel(ja, ta.numpy()) <= RTOL


def test_row_quantize8_codes_exact():
    """The decode kernel's per-row 8-bit codes, scale and zero point are
    the reference kernel's (its quantize, compiled), bit for bit."""
    rng = np.random.default_rng(14)
    x = (rng.standard_normal((4, 40)) * 5).astype(np.float32)
    x[3] = 0.25                                        # a flat row
    q, sx, zx = TDM.row_quantize8(_t(x))

    @jax.jit
    def reference(a):
        mn = jnp.min(a, axis=-1, keepdims=True)
        mx = jnp.max(a, axis=-1, keepdims=True)
        s = jnp.maximum((mx - mn) / 255.0, 1e-8)
        z = jnp.round(-mn / s)
        return jnp.clip(jnp.round(a / s) + z, 0.0, 255.0), s, z

    jq, js, jz = reference(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(),
                                  (np.asarray(jq) - 128).astype(np.int8))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(js)[:, 0])
    np.testing.assert_array_equal(zx.numpy(), np.asarray(jz)[:, 0] - 128)


# ---------------------------------------------------------------------------
# rows 5 and 6: paged attention (one port kernel)
# ---------------------------------------------------------------------------


def _pools(block_size, num_hi, spans, seed=0):
    """The port's pools from :func:`paged_pools` and the same pools as JAX
    arrays."""
    entry, ht, lt = paged_pools(block_size, num_hi, spans, seed=seed)
    jentry = {name: jnp.asarray(a.numpy()) for name, a in entry.items()}
    return entry, jentry, ht, lt


@pytest.mark.parametrize("block_size", [4, 16])
def test_ragged_attention_matches_pallas(block_size):
    """Mixed prefill and decode spans in one call, GQA rep 2: a continuation
    chunk with an odd valid length, a first chunk shorter than ``num_hi``,
    and decode spans (one with ``num_hi >= length``).  Only valid chunk
    rows are compared; pad rows are discarded by the caller."""
    num_hi, c_len, h = 16, 12, 4
    spans = [(16, 27), (0, 9), (29, 30), (8, 9)]
    entry, jentry, ht, lt = _pools(block_size, num_hi, spans, seed=block_size)
    rng = np.random.default_rng(block_size + 1)
    q_pf = rng.standard_normal((2, c_len, h, 16)).astype(np.float32)
    q_dec = rng.standard_normal((2, 1, h, 16)).astype(np.float32)
    starts = np.array([s for s, _ in spans], np.int32)
    lengths = np.array([l for _, l in spans], np.int32)
    j_pf, j_dec = paged_ragged_attention(
        jentry, jnp.asarray(q_pf), jnp.asarray(q_dec), jnp.asarray(starts),
        jnp.asarray(lengths), jnp.asarray(ht), jnp.asarray(lt), block_size,
        interpret=True)
    t_pf, t_dec = TPA.paged_ragged_attention(
        entry, _t(q_pf), _t(q_dec), _t(starts), _t(lengths), _t(ht), _t(lt),
        block_size)
    for i in range(2):
        n = int(lengths[i] - starts[i])
        np.testing.assert_allclose(t_pf[i, :n].numpy(),
                                   np.asarray(j_pf[i, :n], np.float32),
                                   rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(t_dec.numpy(), np.asarray(j_dec, np.float32),
                               rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("block_size", [4, 16])
def test_dense_attention_oracle_matches_reference_oracle(block_size):
    """``kernels/ref.py``'s dense oracle against the reference's
    ``paged_ragged_attention_ref`` on the same pools."""
    spans = [(16, 27), (0, 9), (29, 30), (8, 9)]
    entry, jentry, ht, lt = _pools(block_size, 16, spans, seed=7)
    rng = np.random.default_rng(8)
    q_pf = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    q_dec = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    starts = np.array([s for s, _ in spans], np.int32)
    lengths = np.array([l for _, l in spans], np.int32)
    j_pf, j_dec = JR.paged_ragged_attention_ref(
        jentry, jnp.asarray(q_pf), jnp.asarray(q_dec), jnp.asarray(starts),
        jnp.asarray(lengths), jnp.asarray(ht), jnp.asarray(lt))
    t_pf, t_dec = TR.paged_ragged_attention_ref(
        entry, _t(q_pf), _t(q_dec), _t(starts), _t(lengths), _t(ht), _t(lt))
    for i in range(2):
        n = int(lengths[i] - starts[i])
        np.testing.assert_allclose(t_pf[i, :n].numpy(),
                                   np.asarray(j_pf[i, :n]), rtol=RTOL,
                                   atol=RTOL)
    np.testing.assert_allclose(t_dec.numpy(), np.asarray(j_dec), rtol=RTOL,
                               atol=RTOL)


@pytest.mark.parametrize("block_size", [4, 16])
def test_decode_attention_matches_pallas(block_size):
    """The all-decode step (row 5, ``paged_decode_attention``) is the port
    kernel's ``n_pf = 0`` case, GQA rep 4."""
    num_hi, h = 16, 8
    spans = [(l - 1, l) for l in (5, 16, 17, 38)]
    entry, jentry, ht, lt = _pools(block_size, num_hi, spans, seed=3)
    q = np.random.default_rng(4).standard_normal((4, 1, h, 16)).astype(
        np.float32)
    lengths = np.array([l for _, l in spans], np.int32)
    ja = paged_decode_attention(jentry, jnp.asarray(q), jnp.asarray(lengths),
                                jnp.asarray(ht), jnp.asarray(lt), block_size,
                                interpret=True)
    q_pf = torch.zeros((0, 1, h, 16))
    _, ta = TPA.paged_ragged_attention(entry, q_pf, _t(q), _t(lengths - 1),
                                       _t(lengths), _t(ht), _t(lt),
                                       block_size)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja, np.float32),
                               rtol=RTOL, atol=RTOL)
    tr = TR.paged_attention_ref(entry, _t(q), _t(lengths), _t(ht), _t(lt))
    np.testing.assert_allclose(tr.numpy(), ta.numpy(), rtol=RTOL, atol=RTOL)


def test_ragged_attention_refuses_an_empty_slot_array():
    entry, _, ht, lt = _pools(4, 4, [(0, 5)])
    q = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError):
        TPA.paged_ragged_attention(entry, q, torch.zeros((0, 1, 2, 16)),
                                   torch.zeros(1, dtype=torch.int32),
                                   torch.tensor([5], dtype=torch.int32),
                                   _t(ht), _t(lt), 4)


# ---------------------------------------------------------------------------
# launch counters: the plain versions never count
# ---------------------------------------------------------------------------


def test_plain_versions_do_not_count_launches():
    TO.reset_launch_counts()
    rng = np.random.default_rng(15)
    _, tp = _weights(rng, 16, 8)
    x = torch.from_numpy(rng.standard_normal((1, 8, 16)).astype(np.float32))
    TO.stamp_quant_matmul(x, tp.qw, tp.sw, tp.zw, tp.qw_sum, num_hi=4)
    TDM.stamp_decode_matmul(x[0], tp.qw, tp.sw, tp.zw, tp.qw_sum)
    from test_torch_cuda import grouped_case
    TO.stamp_quant_grouped_matmul(*grouped_case(1, 2, 4, 16, 32, [[4, 1]],
                                                "cpu"))
    kv, q = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
             for shape in ((1, 12, 2, 16), (1, 1, 4, 16)))
    entry = TKV.quantize_full(kv, kv, TKV.KVCacheConfig(num_hi=4))
    TO.cache_decode_attention(entry, q, torch.tensor([7], dtype=torch.int32))
    assert TO.launch_counts() == {
        "stamp_transform_quantize": 0, "stamp_int_gemm": 0,
        "stamp_decode_matmul": 0, "paged_ragged_attention": 0,
        "stamp_quant_grouped_matmul": 0, "cache_decode_attention": 0,
        "int8_matmul": 0, "quantize_pack": 0, "haar_dwt_seq": 0,
        "walsh_hadamard": 0, "stamp_span_transform": 0}

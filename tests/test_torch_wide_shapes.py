"""The port's plain versions against the JAX reference at the shapes its
CUDA kernels took on late: head_dim 112 with 8 query heads a kv head
(Kimi-K2's attention, ``configs/kimi_k2_1t_a32b.py``) for the paged and
the contiguous-cache attention, and more decode rows than one of K3's
16-row tiles for the decode matmul.  The reference runs compiled
(``jax.jit``) with its Pallas kernels in interpret mode, as the JAX suite
runs them on the CPU; the port runs the plain versions its wrappers take on
CPU tensors.  Float outputs agree within ``rtol = 1e-5`` (summation and
softmax order differ; the integer products are exact on both sides).

The CUDA kernels are held against these plain versions on a card in
``test_torch_cuda.py`` (``*_head_dim_112``, ``test_cuda_decode_matmul_
tilings``) and in ``chip_smoke.py``."""

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
from repro.kernels.cache_attention import (
    cache_decode_attention as j_cache_attention)
from repro.kernels.paged_attention import (paged_decode_attention,
                                           paged_ragged_attention)
from repro.serving import kvcache as JKV

from repro_torch.core import stamp as TS
from repro_torch.kernels import decode_matmul as TDM
from repro_torch.kernels import paged_attention as TPA
from repro_torch.kernels.cache_attention import cache_decode_attention
from repro_torch.serving import kvcache as TKV
from test_torch_cuda import paged_pools

RTOL = 1e-5
HD, REP = 112, 8          # Kimi-K2: head_dim 112, 64 query heads over 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


@pytest.mark.parametrize("block_size", [4, 16])
def test_ragged_attention_head_dim_112_matches_pallas(block_size):
    """A mixed step (a continuation chunk, a first chunk shorter than
    ``num_hi`` and two decode spans) at head_dim 112, 2 kv heads of 8
    query heads each; valid chunk rows compared."""
    num_hi, c_len, g = 16, 12, 2
    spans = [(16, 27), (0, 9), (29, 30), (8, 9)]
    entry, ht, lt = paged_pools(block_size, num_hi, spans, g=g, hd=HD,
                                seed=block_size)
    jentry = {name: jnp.asarray(a.numpy()) for name, a in entry.items()}
    rng = np.random.default_rng(block_size + 1)
    q_pf = rng.standard_normal((2, c_len, g * REP, HD)).astype(np.float32)
    q_dec = rng.standard_normal((2, 1, g * REP, HD)).astype(np.float32)
    starts = np.array([s for s, _ in spans], np.int32)
    lengths = np.array([n for _, n in spans], np.int32)
    j_pf, j_dec = jax.jit(lambda *a: paged_ragged_attention(
        *a, block_size, interpret=True))(
        jentry, jnp.asarray(q_pf), jnp.asarray(q_dec), jnp.asarray(starts),
        jnp.asarray(lengths), jnp.asarray(ht), jnp.asarray(lt))
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
def test_decode_attention_head_dim_112_matches_pallas(block_size):
    """The all-decode step (``paged_decode_attention``, the port kernel's
    ``n_pf = 0`` case) at head_dim 112 with 8 query heads a kv head, spans
    inside and past the hi region."""
    num_hi, g = 16, 2
    spans = [(n - 1, n) for n in (5, 16, 17, 70)]
    entry, ht, lt = paged_pools(block_size, num_hi, spans, g=g, hd=HD,
                                seed=3)
    jentry = {name: jnp.asarray(a.numpy()) for name, a in entry.items()}
    q = np.random.default_rng(4).standard_normal(
        (4, 1, g * REP, HD)).astype(np.float32)
    lengths = np.array([n for _, n in spans], np.int32)
    ja = jax.jit(lambda *a: paged_decode_attention(
        *a, block_size, interpret=True))(
        jentry, jnp.asarray(q), jnp.asarray(lengths), jnp.asarray(ht),
        jnp.asarray(lt))
    _, ta = TPA.paged_ragged_attention(
        entry, torch.zeros((0, 1, g * REP, HD)), _t(q), _t(lengths - 1),
        _t(lengths), _t(ht), _t(lt), block_size)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja, np.float32),
                               rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("lengths", [(100,), (5, 30, 130)])
def test_cache_attention_head_dim_112_matches_pallas(lengths):
    """The contiguous cache's decode attention at head_dim 112, 8 query
    heads a kv head: one shared length, and ragged lengths inside the hi
    region, inside the first lo block and across blocks."""
    b, s, g, num_hi, bs = len(lengths), 168, 2, 8, 32
    rng = np.random.default_rng(42)
    k = rng.standard_normal((b, s, g, HD)).astype(np.float32)
    v = rng.standard_normal((b, s, g, HD)).astype(np.float32)
    q = rng.standard_normal((b, 1, g * REP, HD)).astype(np.float32)
    jcfg = JKV.KVCacheConfig(quantized=True, num_hi=num_hi)
    jent = jax.jit(lambda a, c: JKV.quantize_full(a, c, jcfg))(
        jnp.asarray(k), jnp.asarray(v))
    tent = TKV.quantize_full(_t(k), _t(v),
                             TKV.KVCacheConfig(quantized=True, num_hi=num_hi))
    length = np.asarray(lengths, np.int32)
    want = jax.jit(lambda e, a, n: j_cache_attention(
        e, a, n, block_s=bs, interpret=True))(jent, jnp.asarray(q),
                                              jnp.asarray(length))
    got = cache_decode_attention(tent, _t(q), _t(length))
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) <= RTOL


@pytest.mark.parametrize("rows", [17, 32])
def test_decode_matmul_past_one_row_tile_matches_pallas(rows):
    """Decode slots past K3's 16-row tile (the reference takes any number)
    through the decode matmul's plain version, with a bias, against
    ``stamp_decode_matmul_pallas``."""
    rng = np.random.default_rng(rows)
    k, n = 256, 96
    x = (rng.standard_normal((rows, k)) * 3).astype(np.float32)
    bias = rng.standard_normal((n,)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k)
    jp, tp = JS.prepare_linear(jnp.asarray(w)), TS.prepare_linear(_t(w))
    ja = jax.jit(lambda *a: JO.stamp_decode_matmul(
        *a, out_dtype=jnp.float32, interpret=True))(
        jnp.asarray(x), jp.qw, jp.sw, jp.zw, jnp.asarray(bias))
    ta = TDM.stamp_decode_matmul(_t(x), tp.qw, tp.sw, tp.zw, tp.qw_sum,
                                 _t(bias))
    assert ta.shape == (rows, n)
    assert _rel(ja, ta.numpy()) <= RTOL

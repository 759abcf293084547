"""The K1 → K2 chain over spans longer than K2's 128-row tile, on the CPU.

Past ``MAX_SPAN`` rows the wrappers of ``repro_torch.kernels.stamp_matmul``
take the long-span chain: K2 without a transform over 128-row tiles, then
the span link's inverse transform with the bias and the dual's
``silu(g)·u``; under the WHT past ``TQ_MAX_IN`` window rows the span link
also runs the forward transform before K1.  On the CPU each link is its
plain version, so this file holds the chain's routing and arithmetic:
bit-equal to the single plain versions (``transform_quantize_plain`` →
``int_gemm_plain``), and against the reference's interpret-mode Pallas
kernels (which hold the whole span) within the ``rtol`` of
``test_torch_kernels.py``.  K1's windows (``tq_fits``) run here too; the
span link's launch plans run in ``test_torch_span_link.py``, and the CUDA
kernels are held to these plain versions in ``test_torch_cuda.py``.
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

from repro_torch.core import stamp as TS
from repro_torch.kernels import ops as TO
from repro_torch.kernels import stamp_matmul as TSM

RTOL = 1e-5
K, N = 48, 40


def _weights(rng, k=K, n=N):
    w = rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k)
    return JS.prepare_linear(jnp.asarray(w)), \
        TS.prepare_linear(torch.from_numpy(w))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


@pytest.mark.parametrize("span", [129, 256, 1024])
@pytest.mark.parametrize("transform", ["none", "dwt", "wht"])
@pytest.mark.parametrize("dual", [False, True])
def test_long_span_chain_matches_plain_and_pallas(span, transform, dual):
    """Two spans of 129 to 1024 rows at narrow widths (K 48, N 40, a bias
    on the gate): the chain's codes, scales and zero points and its f32
    output bit-equal to the single plain versions, and the composed op
    within ``RTOL`` of ``stamp_quant_matmul_pallas`` /
    ``stamp_quant_dual_matmul_pallas`` in interpret mode."""
    rng = np.random.default_rng(span + len(transform) + dual)
    x = rng.standard_normal((2, span, K)).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32)
    tx = torch.from_numpy(x)
    st = dict(transform=transform, levels=3, skip_first=True)
    qkw = dict(num_hi=8, hi_bits=8, lo_bits=4, **st)
    q = TSM.stamp_transform_quantize(tx, **qkw)
    for got, want in zip(q, TSM.transform_quantize_plain(tx, **qkw)):
        assert torch.equal(got, want)
    ws = [_weights(rng) for _ in range(2 if dual else 1)]
    wargs = [ws[0][1].qw, ws[0][1].sw, ws[0][1].zw, ws[0][1].qw_sum,
             torch.from_numpy(bias)]
    if dual:
        wargs += [ws[1][1].qw, ws[1][1].sw, ws[1][1].zw, ws[1][1].qw_sum,
                  None]
    kw = dict(out_dtype=torch.float32, **st)
    y = TSM.stamp_int_gemm(*q, span, *wargs, **kw)
    assert torch.equal(y, TSM.int_gemm_plain(*q, span, *wargs, **kw))
    jw = [w[0] for w in ws]
    if dual:
        ja = JO.stamp_quant_dual_matmul(
            jnp.asarray(x), jw[0].qw, jw[0].sw, jw[0].zw, jw[1].qw,
            jw[1].sw, jw[1].zw, jnp.asarray(bias), out_dtype=jnp.float32,
            interpret=True, **qkw)
        ta = TO.stamp_quant_dual_matmul(tx, *wargs[:4], *wargs[5:9],
                                        wargs[4], out_dtype=torch.float32,
                                        **qkw)
    else:
        ja = JO.stamp_quant_matmul(jnp.asarray(x), jw[0].qw, jw[0].sw,
                                   jw[0].zw, jnp.asarray(bias),
                                   out_dtype=jnp.float32, interpret=True,
                                   **qkw)
        ta = TO.stamp_quant_matmul(tx, *wargs[:5], out_dtype=torch.float32,
                                   **qkw)
    assert torch.equal(ta, y)
    assert _rel(ja, ta.numpy()) <= RTOL


@pytest.mark.parametrize("transform", ["dwt", "wht"])
@pytest.mark.parametrize("inverse", [False, True])
def test_span_link_plain_is_the_transform(transform, inverse):
    """The span link's plain version: the port's sequence transform (or
    its inverse) of each span in f32, then the bias, and for the dual
    ``silu(g + b)·(u + b_up)``, in the output dtype."""
    from repro_torch.core import transforms as T
    rng = np.random.default_rng(7)
    g = torch.from_numpy(rng.standard_normal((2, 300, 16)).astype(
        np.float32))
    u = torch.from_numpy(rng.standard_normal((2, 300, 16)).astype(
        np.float32))
    b = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    kw = dict(transform=transform, levels=3, skip_first=True,
              inverse=inverse)
    fn = T.inverse_sequence_transform if inverse else T.sequence_transform
    t = dict(axis=-2, levels=3, skip_first=True)
    assert torch.equal(TSM.stamp_span_transform(g, **kw),
                       fn(g, transform, **t))
    want = TSM.silu(fn(g, transform, **t) + b) * (fn(u, transform, **t) + b)
    got = TSM.stamp_span_transform(g, u, b, b, out_dtype=torch.bfloat16,
                                   **kw)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))


def test_tq_fits_picks_the_chain_only_where_windows_outgrow_k1():
    """K1's own windows take every Haar DWT span of up to 4 levels (a
    window of 16 outputs needs at most 16·2^levels rows, the odd-band carry
    that joins the first and last row groups included) and the WHT up to a
    256-row block; past that the span link runs first."""
    for s in (129, 256, 257, 1024, 1025, 2048, 4096, 4097):
        for levels in (1, 3, 4):
            for skip in (True, False):
                windows = TSM.tq_windows(s, "dwt", levels, skip)
                assert max(len(w[0]) for w in windows) <= \
                    TSM.TQ_OUT << levels <= TSM.TQ_MAX_IN
                assert TSM.tq_fits(s, "dwt", levels, skip)
        assert TSM.tq_fits(s, "none", 3, True)
    # the sink row stays out of the transform: 512 rows hold a 256 block
    assert TSM.tq_fits(512, "wht", 3, True)
    assert not TSM.tq_fits(512, "wht", 3, False)
    assert not TSM.tq_fits(513, "wht", 3, True)
    for s, levels in ((1024, 5), (2048, 7)):
        windows = TSM.tq_windows(s, "dwt", levels, True)
        assert TSM.tq_fits(s, "dwt", levels, True) == \
            (max(len(w[0]) for w in windows) <= TSM.TQ_MAX_IN)
    # the K1 wrapper routes through the span link exactly there
    x = torch.randn((1, 600, 8))
    TO.reset_launch_counts()
    q = TSM.stamp_transform_quantize(x, transform="wht", num_hi=4)
    assert all(torch.equal(a, b) for a, b in zip(
        q, TSM.transform_quantize_plain(x, transform="wht", levels=3,
                                        skip_first=True, num_hi=4,
                                        hi_bits=8, lo_bits=4)))
    assert set(TO.launch_counts().values()) == {0}   # plain versions


def test_gemm_plan_tiles_a_long_span_without_a_transform():
    """Without a transform K2 takes a long span as 128-row tiles, the last
    one ragged: the plan counts ``ceil(rows / 128)`` tiles of blocks."""
    rows = 2 * 300
    plan = TSM.gemm_plan(-(-rows // TSM.MAX_SPAN), 4096, 6144, False, 132)
    assert plan["col_tiles"] == 48 and plan["n_split"] == 1

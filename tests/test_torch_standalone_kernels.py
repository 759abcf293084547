"""The port's standalone kernel library against the JAX reference's.

``repro_torch.kernels.ops`` offers ``haar_dwt_seq`` (K9), ``walsh_hadamard``
(K10), ``quantize_pack`` (K8) and ``int8_matmul`` (K7).  On the CPU each
wrapper runs its plain PyTorch version, so these tests hold that arithmetic
against the Pallas kernels in interpret mode (``repro.kernels.ops.*(…,
interpret=True)``), case for case with ``tests/test_kernels.py``, on the same
numpy inputs:

- K8's codes, scales and zero points are bit-equal;
- K10 is bit-equal along both axes, in f32 and bf16;
- K9 is bit-equal at one level and for the inverse at every level; the
  forward transform from two levels on is not bit-equal to the Pallas
  kernel, which XLA compiles with FMA contractions, nor at short sequences
  to ``jax.jit`` of ``repro.kernels.ref.haar_dwt_ref``
  (``test_dwt_levels_against_both_programs`` records where, and
  ``test_pallas_forward_dwt_is_fma_contracted`` emulates the Pallas
  contraction exactly);
- K7's f32 output is bit-equal (exact int32 sums, the same f32 epilogue).

The CUDA kernels themselves are held against these plain versions in
``test_torch_cuda.py`` (on a card) and in ``chip_smoke.py``.
"""

import subprocess
import sys
from pathlib import Path

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

from repro.kernels import ops as JO
from repro.kernels import ref as JR

from repro_torch.core import transforms as T
from repro_torch.core.quant import recip32
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR
from repro_torch.kernels import wht as TW

# the Pallas forward DWT from two levels on: XLA's FMA contractions move it
# by at most 1.5e-7 of the largest magnitude (measured over the shapes
# here); 2^-22 = 2.4e-7
DWT_FMA_REL = 2.0 ** -22


def rand(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bf16" else
                              jnp.float32)
    t = torch.from_numpy(x)
    return j, t.bfloat16() if dtype == "bf16" else t


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.is_floating_point() else a.numpy()
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                      else a)


def _rel(a, b) -> float:
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _within_bf16_step(a, b) -> bool:
    a, b = _np(a), _np(b)
    return bool((np.abs(a - b) <= 2.0 ** -7 * np.abs(b) + 1e-6).all())


# ---------------------------------------------------------------------------
# K9: haar_dwt_seq (TestHaarDWT)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 64, 128), (2, 128, 256),
                                   (3, 256, 128)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("levels", [1, 2, 3, 4])
def test_haar_dwt_forward_matches_pallas(shape, dtype, levels):
    """One level: bit-equal.  From two levels on the Pallas program is
    FMA-contracted: f32 within ``DWT_FMA_REL`` of the largest magnitude,
    bf16 within one bf16 step per element."""
    jx, tx = _pair(rand(shape), dtype)
    want = JO.haar_dwt_seq(jx, levels=levels, interpret=True)
    got = TO.haar_dwt_seq(tx, levels=levels)
    assert got.shape == shape and got.dtype == tx.dtype
    if levels == 1:
        np.testing.assert_array_equal(_np(got), _np(want))
    elif dtype == "f32":
        assert _rel(got, want) <= DWT_FMA_REL
    else:
        assert _within_bf16_step(got, want)


@pytest.mark.parametrize("levels", [1, 2, 4])
def test_haar_dwt_inverse_roundtrip(levels):
    """The inverse is bit-equal to the Pallas inverse of the same input, and
    the round trip returns the input within 1e-5."""
    x = rand((2, 128, 128), seed=1)
    y = TO.haar_dwt_seq(torch.from_numpy(x), levels=levels)
    back = TO.haar_dwt_seq(y, levels=levels, inverse=True)
    want = JO.haar_dwt_seq(jnp.asarray(y.numpy()), levels=levels,
                           inverse=True, interpret=True)
    np.testing.assert_array_equal(back.numpy(), np.asarray(want))
    np.testing.assert_allclose(back.numpy(), x, atol=1e-5)


def test_haar_dwt_long_sequence():
    """The reference's ``block_d`` shrink case (s = 16384, d = 16): K9 has
    no feature tile, the numbers are the same."""
    x = rand((1, 16384, 16), seed=2)
    want = JO.haar_dwt_seq(jnp.asarray(x), levels=3, interpret=True)
    got = TO.haar_dwt_seq(torch.from_numpy(x), levels=3)
    assert _rel(got, want) <= DWT_FMA_REL
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax.jit(JR.haar_dwt_ref, static_argnums=1)(
            jnp.asarray(x), 3)))


# The remaining reference-execution fault of ROADMAP §3, pinned at the
# standalone multi-level DWT: where the port's plain Haar transform is
# bit-equal to the Pallas kernel and to the jitted oracle, level by level.
# Measured on f32 normals: every inverse and the one-level forward are
# bit-equal to both programs at both shapes.  From two levels on the forward
# differs from the Pallas kernel (8342 / 10727 / 5462 / 10306 of 65536
# elements at levels 2 / 3 / 4 / 5 on (2, 256, 128)), by at most 1.5e-7 of
# the largest magnitude; jax.jit(haar_dwt_ref) is bit-equal to the port at
# s = 256 but contracted as well at s = 64 (1017 / 1333 / 687 / 347 of 8192
# elements on (1, 64, 128)): XLA's choice depends on the program's size.
DWT_PALLAS_EQUAL = {(False, 1), (True, 1), (True, 2), (True, 3), (True, 4),
                    (True, 5)}


@pytest.mark.parametrize("shape", [(2, 256, 128), (1, 64, 128)])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("levels", [1, 2, 3, 4, 5])
def test_dwt_levels_against_both_programs(shape, levels, inverse):
    x = rand(shape, seed=3)
    got = TO.haar_dwt_seq(torch.from_numpy(x), levels=levels,
                          inverse=inverse).numpy()
    programs = {
        "jit": (np.asarray(jax.jit(JR.haar_dwt_ref, static_argnums=(1, 2))(
            jnp.asarray(x), levels, inverse)),
                (inverse, levels) in DWT_PALLAS_EQUAL or shape[1] == 256),
        "pallas": (np.asarray(JO.haar_dwt_seq(
            jnp.asarray(x), levels=levels, inverse=inverse, interpret=True)),
                   (inverse, levels) in DWT_PALLAS_EQUAL)}
    for name, (want, equal) in programs.items():
        if equal:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert (got != want).any(), name
            assert _rel(got, want) <= DWT_FMA_REL, name


# Which levels of the Pallas forward program XLA contracts: at level l >= 2
# the approximation (even + odd)·r and detail (even − odd)·r read the even
# input as its unrounded product, fma(s_even, r, ±odd)·r, where s_even is
# the previous level's sum.  "c" marks a contracted level, "-" a plain one.
DWT_CONTRACTED = {2: "-c", 3: "-cc", 4: "--cc", 5: "-c-cc"}


def _dwt_fma_emulation(x: np.ndarray, pattern: str) -> np.ndarray:
    r = np.float32(recip32(T.SQRT2))

    def fma(a, c):   # a·r + c, rounded once (exact product in f64)
        return (a.astype(np.float64) * np.float64(r) + c).astype(np.float32)

    out, lo, pre = x.copy(), x.shape[1], None
    for mode in pattern:
        even, odd = out[:, 0:lo:2], out[:, 1:lo:2]
        if mode == "c":
            s_even = pre[:, 0::2]
            pre, dpre = fma(s_even, odd), fma(s_even, -odd)
        else:
            pre, dpre = even + odd, even - odd
        out = np.concatenate([pre * r, dpre * r, out[:, lo:]], axis=1)
        lo //= 2
    return out


@pytest.mark.parametrize("shape", [(2, 256, 128), (1, 512, 16)])
@pytest.mark.parametrize("levels", [2, 3, 4, 5])
def test_pallas_forward_dwt_is_fma_contracted(shape, levels):
    """The port's plain forward DWT with the contractions of
    ``DWT_CONTRACTED`` is bit-equal to the Pallas program, and without them
    (``"-" * levels``) it is the port's plain version: the gap is XLA's
    FMA contraction and nothing else."""
    x = rand(shape, seed=levels)
    pallas = np.asarray(JO.haar_dwt_seq(jnp.asarray(x), levels=levels,
                                        interpret=True))
    np.testing.assert_array_equal(
        _dwt_fma_emulation(x, DWT_CONTRACTED[levels]), pallas)
    np.testing.assert_array_equal(
        _dwt_fma_emulation(x, "-" * levels),
        TO.haar_dwt_seq(torch.from_numpy(x), levels=levels).numpy())


def test_haar_dwt_k9_group_layout():
    """K9's thread layout, run in PyTorch: each group of 2^L rows is
    transformed on its own and scattered to row g (approximation) and rows
    s/2^l + g·2^(L−l) + j (level-l details); the inverse gathers the same
    rows.  Both equal the plain transform bit for bit."""
    levels, (b, s, d) = 3, (2, 64, 24)
    n = 1 << levels
    x = torch.from_numpy(rand((b, s, d), seed=4))
    r = torch.tensor(recip32(T.SQRT2))
    groups = s // n
    v = x.reshape(b, groups, n, d)
    for l in range(1, levels + 1):
        m = n >> (l - 1)
        e, o = v[:, :, 0:m:2], v[:, :, 1:m:2]
        v = torch.cat([(e + o) * r, (e - o) * r, v[:, :, m:]], dim=2)
    rows = [torch.arange(groups) * 1]
    for l in range(1, levels + 1):
        cnt = n >> l
        rows.append((s >> l) + torch.arange(groups)[:, None] * cnt
                    + torch.arange(cnt))
    y = torch.empty_like(x)
    y[:, rows[0]] = v[:, :, 0]
    for l in range(1, levels + 1):
        cnt = n >> l
        y[:, rows[l].reshape(-1)] = v[:, :, cnt:2 * cnt].reshape(b, -1, d)
    assert torch.equal(y, T.haar_dwt(x, levels=levels, axis=-2))
    # inverse: gather the group's rows, undo the deepest level first
    w = torch.cat([y[:, rows[0]][:, :, None]] + [
        y[:, rows[l].reshape(-1)].reshape(b, groups, n >> l, d)
        for l in range(levels, 0, -1)], dim=2)
    for l in range(levels, 0, -1):
        m = n >> (l - 1)
        a, det = w[:, :, :m // 2], w[:, :, m // 2:m]
        band = torch.stack([(a + det) * r, (a - det) * r], dim=3)
        w = torch.cat([band.reshape(b, groups, m, d), w[:, :, m:]], dim=2)
    assert torch.equal(w.reshape(b, s, d),
                       T.haar_idwt(y, levels=levels, axis=-2))


def test_haar_dwt_past_five_levels_chains_the_same_levels():
    """Past K9's five levels a launch chain runs the remaining levels on the
    approximation band: the same operations as the plain transform."""
    x = torch.from_numpy(rand((1, 256, 8), seed=5))
    want = TO.haar_dwt_seq(x, levels=7)
    y = TO.haar_dwt_seq(x, levels=5)
    y[:, :8] = TO.haar_dwt_seq(y[:, :8].contiguous(), levels=2)
    assert torch.equal(y, want)
    back = TO.haar_dwt_seq(want, levels=7, inverse=True)
    z = want.clone()
    z[:, :8] = TO.haar_dwt_seq(z[:, :8].contiguous(), levels=2, inverse=True)
    assert torch.equal(back, TO.haar_dwt_seq(z, levels=5, inverse=True))


# ---------------------------------------------------------------------------
# K10: walsh_hadamard (TestWHT)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("axis", [-2, -1])
@pytest.mark.parametrize("shape", [(2, 128, 256), (1, 64, 128)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_wht_matches_pallas(axis, shape, dtype):
    """Bit-equal along both axes: the same stages in the same order and one
    f32(1/√n) scale (the Pallas constant f32(1/√n) equals the port's
    f32(1)/f32(√n) at every power of two)."""
    jx, tx = _pair(rand(shape, seed=3), dtype)
    want = JO.walsh_hadamard(jx, axis=axis, interpret=True)
    got = TO.walsh_hadamard(tx, axis=axis)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(_np(got), _np(want))


def test_wht_involution():
    x = torch.from_numpy(rand((2, 128, 128), seed=4))
    y = TO.walsh_hadamard(TO.walsh_hadamard(x))
    np.testing.assert_allclose(y.numpy(), x.numpy(), atol=1e-4)


def _run_plan(x: torch.Tensor, plan, n: int) -> torch.Tensor:
    """K10's launches on a (b, s, d) tensor, in PyTorch: each launch gathers
    its tiles through its address formula (element j of vector c of tile t
    of batch z at z·bstride + c·vstride + (t·tmul + j·istride)·ax), runs
    the tile's stages as the plain WHT does, and scatters them back; the
    last scales by f32(1/√n).  Every launch covers each element once."""
    flat = x.reshape(-1)
    for st in plan:
        idx = (torch.arange(st.batches)[:, None, None, None] * st.bstride
               + torch.arange(st.nvec)[None, :, None, None] * st.vstride
               + (torch.arange(st.tiles)[None, None, :, None] * st.tmul
                  + torch.arange(st.T)[None, None, None, :] * st.istride)
               * st.ax)
        assert torch.equal(idx.flatten().sort().values,
                           torch.arange(flat.numel()))
        tile = flat[idx]                      # (batches, nvec, tiles, T)
        h = 1
        while h < st.T:
            sh = tile.reshape(*tile.shape[:-1], st.T // (2 * h), 2, h)
            a, b = sh[..., 0, :], sh[..., 1, :]
            tile = torch.stack([a + b, a - b], dim=-2).reshape(tile.shape)
            h *= 2
        flat = flat.clone()
        flat[idx] = tile
        if st.last:
            flat = flat * torch.tensor(recip32(np.sqrt(n)))
    return flat.reshape(x.shape)


@pytest.mark.parametrize("n,feature", [(8192, False), (16384, False),
                                       (2048, False), (1 << 16, True)])
def test_wht_split_plan_is_the_plain_transform(n, feature):
    """Where a vector does not fit one block, K10 splits the stages over
    two launches through an f32 scratch (a long feature vector's second
    launch sees each row as (n / T1, T1) and transforms its sequence
    axis); run in PyTorch, the plan is the plain transform bit for bit."""
    shape = (3, 1, n) if feature else (1, n, 8)
    plan = TW.plan(*shape, seq=not feature, itemsize=2)
    assert len(plan) == (1 if n == 2048 else 2)
    x = torch.from_numpy(rand(shape, seed=6))
    axis = -1 if feature else -2
    assert torch.equal(_run_plan(x, plan, n), T.wht(x, axis=axis))


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape,axis", [
    ((2, 2, 128), -2), ((2, 32, 128), -2), ((1, 256, 384), -2),
    ((4, 2048, 4096), -2), ((1, 4096, 128), -2),
    ((3, 5, 2), -1), ((2, 7, 4), -1), ((2, 3, 32), -1), ((1, 100, 256), -1),
    ((4, 2048, 4096), -1), ((1, 3, 32768), -1)])
def test_wht_launch_plan(shape, axis, itemsize):
    """K10's plans for 16- and 32-bit elements: one launch whose tile is
    the whole vector, bar a sequence longer than the longest tile (4096
    positions in f32, 2048 in 16 bits: two launches); a sequence block
    takes whole chunks of 4 columns and rows of at least 32 bytes of its
    output, a feature block whole rows; a tile that needs more than one
    register phase (over 8 chunk positions) fits ``SMEM_BYTES`` as f32
    unless its width is that least one (then ``MAX_SMEM_BYTES``) or it is
    one feature row; run in PyTorch, the plan is the plain transform bit
    for bit."""
    b, s, d = shape
    seq = axis == -2
    n = s if seq else d
    plan = TW.plan(b, s, d, seq, itemsize)
    split = seq and n * 4 * max(32 // itemsize, 4) > TW.MAX_SMEM_BYTES
    assert len(plan) == (2 if split else 1) and plan[-1].last
    for st in plan:
        out = itemsize if st.last else 4
        positions = st.T if seq else st.T // 4
        if seq:
            assert st.vstride == 1 and st.w % 4 == 0 and st.w * out >= 32
        if positions > 8:
            assert 4 * st.T * st.w <= TW.MAX_SMEM_BYTES
            if not (seq and st.w * out == 32) and st.w > 1:
                assert 4 * st.T * st.w <= TW.SMEM_BYTES
    x = torch.from_numpy(rand(shape, seed=7))
    assert torch.equal(_run_plan(x, plan, n), T.wht(x, axis=axis))


# ---------------------------------------------------------------------------
# K8: quantize_pack (TestQuantPack)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [4, 8, 3])
@pytest.mark.parametrize("shape", [(2, 256, 128), (1, 512, 64),
                                   (4, 64, 96)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quant_pack_matches_pallas(bits, shape, dtype):
    """Codes, scales and zero points bit-equal to the Pallas kernel's (the
    compiled kernel divides the range by n as a product with f32(1/n); the
    port's plain version does the same)."""
    jx, tx = _pair(rand(shape, seed=5) * 3, dtype)
    want = JO.quantize_pack(jx, bits=bits, interpret=True)
    got = TO.quantize_pack(tx, bits=bits)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("bits", [4, 8])
def test_quant_pack_dequant_error_within_half_step(bits):
    x = torch.from_numpy(rand((1, 128, 64), seed=6))
    p, s, z = TO.quantize_pack(x, bits=bits)
    deq = TR.unpack_dequant_ref(p, s, z, bits=bits)
    assert float((deq - x).abs().max()) <= float(s.max()) / 2 + 1e-6


# ---------------------------------------------------------------------------
# K7: int8_matmul (TestInt8Matmul)
# ---------------------------------------------------------------------------


def _int8_case(m, n, k, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 16, (m, k)).astype(np.int8),
            rng.integers(0, 16, (k, n)).astype(np.int8),
            rng.uniform(0.01, 0.1, (m, 1)).astype(np.float32),
            rng.integers(0, 16, (m, 1)).astype(np.float32),
            rng.uniform(0.01, 0.1, (1, n)).astype(np.float32),
            rng.integers(0, 16, (1, n)).astype(np.float32))


@pytest.mark.parametrize("mnk", [(128, 128, 128), (256, 128, 384),
                                 (128, 256, 512), (8, 256, 128)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_int8_matmul_matches_pallas(mnk, dtype):
    """Bit-equal to the Pallas kernel in f32 and bf16: the int32 sums are
    exact on both sides and the epilogue runs in the same order."""
    m, n, k = mnk
    args = _int8_case(m, n, k)
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else
              (jnp.float32, torch.float32))
    want = JO.int8_matmul(*map(jnp.asarray, args), out_dtype=jd,
                          interpret=True)
    got = TO.int8_matmul(*map(torch.from_numpy, args), out_dtype=td)
    assert got.shape == (m, n) and got.dtype == td
    np.testing.assert_array_equal(_np(got), _np(want))
    # and the oracle, a dequantized float matmul, to f32 summation order
    assert _rel(got, TR.int8_matmul_ref(*map(torch.from_numpy, args))) \
        <= (1e-5 if dtype == "f32" else 2 ** -8)


def test_quantize_then_matmul_approximates_float():
    """The W4A8 and W8A8 chains through the port's ops: near the float
    matmul they replace, and bit-equal to the same chain through the
    Pallas kernels."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(1, 128, 256)).astype(np.float32)
    w = rng.normal(size=(256, 128)).astype(np.float32) * 0.05
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    qx, sx, zx = TO.quantize_pack(tx, bits=8)
    jq = JO.quantize_pack(jnp.asarray(x), bits=8, interpret=True)
    mn, mx = tw.amin(0, keepdim=True), tw.amax(0, keepdim=True)
    ref_y = tx[0] @ tw
    for n, shift, bound in ((15.0, 0.0, 0.15), (255.0, 128.0, 0.02)):
        swt = torch.clamp_min((mx - mn) / n, 1e-8)
        zwt = torch.round(-mn / swt)
        qw = (torch.clamp(torch.round(tw / swt) + zwt, 0, n) - shift).to(
            torch.int8)
        y = TO.int8_matmul(qx[0], qw, sx[0], zx[0], swt, zwt - shift,
                           out_dtype=torch.float32)
        assert float(torch.linalg.norm(y - ref_y) /
                     torch.linalg.norm(ref_y)) < bound
        jy = JO.int8_matmul(jq[0][0], jnp.asarray(qw.numpy()), jq[1][0],
                            jq[2][0], jnp.asarray(swt.numpy()),
                            jnp.asarray((zwt - shift).numpy()),
                            out_dtype=jnp.float32, interpret=True)
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


# ---------------------------------------------------------------------------
# oracles, refusals, launch counts, exports
# ---------------------------------------------------------------------------


def test_oracles_match_the_reference_oracles():
    """``repro_torch.kernels.ref``'s five new oracles against ``jax.jit``
    of ``repro.kernels.ref``'s: bit-equal (the DWT at a size where XLA does
    not contract it, see above), except the dequantized float matmul
    (summation order, 1e-6 relative)."""
    x = rand((2, 256, 128), seed=9)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for levels, inverse in ((1, False), (3, False), (3, True)):
        want = jax.jit(JR.haar_dwt_ref, static_argnums=(1, 2))(jx, levels,
                                                               inverse)
        np.testing.assert_array_equal(
            TR.haar_dwt_ref(tx, levels, inverse).numpy(), np.asarray(want))
    for axis in (-2, -1):
        np.testing.assert_array_equal(
            TR.wht_ref(tx, axis).numpy(),
            np.asarray(jax.jit(JR.wht_ref, static_argnums=1)(jx, axis)))
    for bits in (4, 8):
        got = TR.quant_pack_ref(tx, bits)
        want = jax.jit(JR.quant_pack_ref, static_argnums=1)(jx, bits)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
        np.testing.assert_array_equal(
            TR.unpack_dequant_ref(*got, bits=bits).numpy(),
            np.asarray(jax.jit(JR.unpack_dequant_ref, static_argnums=3)(
                *want, bits)))
    args = _int8_case(64, 48, 96)
    assert _rel(TR.int8_matmul_ref(*map(torch.from_numpy, args)),
                jax.jit(JR.int8_matmul_ref)(*map(jnp.asarray, args))) <= 1e-6


def _i8(*shape):
    return np.zeros(shape, np.int8)


def _f(*shape):
    return np.ones(shape, np.float32)


# (name, function name, positional inputs, keyword arguments)
REFUSED = [
    ("dwt seq not a multiple of 2^levels", "haar_dwt_seq",
     (_f(1, 12, 8),), {"levels": 3}),
    ("wht seq not a power of two", "walsh_hadamard", (_f(1, 12, 128),),
     {"axis": -2}),
    ("wht seq d not a multiple of 128", "walsh_hadamard", (_f(1, 16, 96),),
     {"axis": -2}),
    ("wht features not a power of two", "walsh_hadamard", (_f(1, 16, 96),),
     {"axis": -1}),
    ("wht features s not a multiple of 128", "walsh_hadamard",
     (_f(1, 200, 16),), {"axis": -1}),
    ("4-bit pack of odd d", "quantize_pack", (_f(1, 8, 7),), {"bits": 4}),
    ("pack s not a multiple of 256", "quantize_pack", (_f(1, 300, 8),),
     {"bits": 4}),
    ("matmul K mismatch", "int8_matmul",
     (_i8(8, 64), _i8(32, 16), _f(8, 1), _f(8, 1), _f(1, 16), _f(1, 16)),
     {}),
    ("matmul M not a multiple of 128", "int8_matmul",
     (_i8(200, 64), _i8(64, 16), _f(200, 1), _f(200, 1), _f(1, 16),
      _f(1, 16)), {}),
    ("matmul row scales not (M, 1)", "int8_matmul",
     (_i8(8, 64), _i8(64, 16), _f(8), _f(8), _f(16), _f(16)), {}),
]

ACCEPTED = [
    ("dwt d = 7", "haar_dwt_seq", (rand((1, 16, 7)),), {"levels": 1}),
    ("dwt zero levels", "haar_dwt_seq", (rand((1, 16, 8)),), {"levels": 0}),
    ("wht features, s = 100 < 128", "walsh_hadamard", (rand((1, 100, 16)),),
     {"axis": -1}),
    ("wht axis 2 is the features", "walsh_hadamard", (rand((1, 16, 16)),),
     {"axis": 2}),
    ("wht axis 0 is the features", "walsh_hadamard", (rand((1, 16, 16)),),
     {"axis": 0}),
    ("8-bit pack of odd d", "quantize_pack", (rand((1, 8, 7)),),
     {"bits": 8}),
    ("matmul M 8, N 5, K 7", "int8_matmul",
     _int8_case(8, 5, 7), {"out_dtype": "f32"}),
]


def _both(fn_name, args, kw):
    jkw = dict(kw)
    tkw = dict(kw)
    if kw.get("out_dtype") == "f32":
        jkw["out_dtype"], tkw["out_dtype"] = jnp.float32, torch.float32
    jfn = getattr(JO, fn_name)
    tfn = getattr(TO, fn_name)
    return (lambda: jfn(*map(jnp.asarray, args), interpret=True, **jkw),
            lambda: tfn(*map(torch.from_numpy, args), **tkw))


@pytest.mark.parametrize("case", REFUSED, ids=[c[0] for c in REFUSED])
def test_wrappers_refuse_what_the_reference_refuses(case):
    """The reference raises (a ValueError, or for the odd 4-bit pack a
    TypeError from its nibble pairing); the port raises ValueError."""
    _, fn_name, args, kw = case
    jrun, trun = _both(fn_name, args, kw)
    with pytest.raises((ValueError, TypeError)):
        jrun()
    with pytest.raises(ValueError):
        trun()


@pytest.mark.parametrize("case", ACCEPTED, ids=[c[0] for c in ACCEPTED])
def test_wrappers_accept_what_the_reference_accepts(case):
    """Edge shapes both sides take give the same result."""
    _, fn_name, args, kw = case
    jrun, trun = _both(fn_name, args, kw)
    want, got = jrun(), trun()
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(_np(g), _np(w))


def test_plain_versions_count_no_launches():
    """On the CPU every wrapper runs its plain version: no launch counts."""
    TO.reset_launch_counts()
    x = torch.from_numpy(rand((1, 64, 128)))
    TO.haar_dwt_seq(x)
    TO.walsh_hadamard(x)
    TO.walsh_hadamard(x, axis=-1)
    q, s, z = TO.quantize_pack(x, bits=8)
    TO.int8_matmul(q[0], torch.zeros((128, 16), dtype=torch.int8), s[0],
                   z[0], torch.ones((1, 16)), torch.zeros((1, 16)))
    counts = TO.launch_counts()
    for name in ("int8_matmul", "quantize_pack", "haar_dwt_seq",
                 "walsh_hadamard"):
        assert name in counts
    assert not any(counts.values())


# the names ``repro.kernels`` exports from its ops module
REFERENCE_OPS_EXPORTS = ("haar_dwt_seq", "int8_matmul", "quantize_pack",
                         "stamp_decode_matmul", "stamp_quant_dual_matmul",
                         "stamp_quant_grouped_matmul", "stamp_quant_matmul",
                         "walsh_hadamard")


def test_package_exports_the_kernel_library_lazily():
    """``repro_torch.kernels`` exports the reference's ops names (the four
    standalone wrappers among them) and imports no kernel module until one
    is asked for."""
    import repro
    import repro.kernels as JK
    import repro_torch.kernels as TK
    for name in REFERENCE_OPS_EXPORTS:
        assert hasattr(JK, name)
        assert getattr(TK, name) is getattr(TO, name)
    code = ("import sys, repro_torch.kernels as K; "
            "assert 'repro_torch.kernels.ops' not in sys.modules; "
            "assert 'repro_torch.kernels.cuda' not in sys.modules; "
            "K.int8_matmul; assert 'repro_torch.kernels.ops' in sys.modules")
    src = Path(__file__).resolve().parents[1] / "src"
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={"PYTHONPATH": str(src), "PATH": ""}, timeout=120)
    assert repro is not None

"""The long-span link's launch plans, run in PyTorch on the CPU.

``stamp_span_transform`` (``repro_torch.kernels.stamp_matmul``, CUDA source
``csrc/span_link.cu``) runs the Haar DWT of a long span as row windows that
the host plans from the transform run symbolically (``span_passes``: one
launch for the inverse, the forward's levels over as many launches as its
windows hold, the low-pass band going through an f32 scratch), and the WHT
as K10's tiles over each span's power-of-two block (``span_wht_plan``),
whose first launch also writes the rows around the block.  Here a small
interpreter runs those plans as the card does (the slots of each window,
the butterflies in place, the outputs read from their slots; the tiles'
stages gathered through their address formulas) and is held bit for bit
to the plain version ``span_transform_plain``, and the inverse to the
reference's ``_seq_inv`` under ``jax.jit``.  The CUDA kernels are held
to the same plain version in ``test_torch_cuda.py``.
"""

import functools

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

from repro.kernels.stamp_matmul import _seq_inv

from repro_torch.core import stamp as TS
from repro_torch.core import transforms as T
from repro_torch.core.quant import recip32
from repro_torch.kernels import stamp_matmul as TSM
from repro_torch.kernels import wht as TW

SPANS = (129, 130, 300, 641, 2048)
LONGEST = 12288   # past the 9557 rows the link's first design held
NUM_HI = 4        # the smoke's and the reduced serve path's hi rows


def _auto(s: int) -> int:
    """The serve path's resolved levels: ``ceil(log2(s / num_hi))``."""
    return TS.StampConfig(levels=None, num_hi_tokens=NUM_HI) \
        .resolved_levels(s)


def _run_windows(src: torch.Tensor, passes, s: int):
    """The window launches of ``passes`` on ``src`` (b, s, n) f32, in f32
    numpy (one add or subtract and one multiply a value, each rounded as
    the card rounds them): returns the final rows (b, s, n)."""
    inv2 = np.float32(recip32(T.SQRT2))
    src = src.numpy().transpose(1, 0, 2)        # rows first
    out = np.full((s,) + src.shape[1:], np.nan, np.float32)
    for windows, band in passes:
        scr = np.full((band,) + src.shape[1:], np.nan, np.float32)
        for ins, prog, outs in windows:
            slots = src[ins]
            for _, i, j in prog:
                a, c = slots[i], slots[j]
                slots[i], slots[j] = (a + c) * inv2, (a - c) * inv2
            for sl, r in outs:
                if r >= 0:
                    out[r] = slots[sl]
                else:
                    scr[-1 - r] = slots[sl]
        src = scr
    return torch.from_numpy(out.transpose(1, 0, 2).copy())


def _epilogue(y, u, bias, bias_up, out_dtype):
    """The link's epilogue on the transformed gate ``y`` (and up ``u``)."""
    if bias is not None:
        y = y + bias
    if u is not None:
        y = TSM.silu(y) * (u if bias_up is None else u + bias_up)
    return y.to(out_dtype)


def _operands(s, n, dual, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.standard_normal((2, s, n)).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal((2, s, n)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    return g.to(dtype), (u.to(dtype) if dual else None), b


@pytest.mark.parametrize("s,levels,skip,inverse", [
    (129, 3, True, True), (130, 1, False, False), (300, 5, True, False),
    (641, 9, True, True), (2048, 9, True, False), (2048, 3, False, True),
    (12288, 9, True, False), (12288, 9, False, True)])
def test_span_passes_write_every_row_once(s, levels, skip, inverse):
    """Every output row in exactly one window of one launch, every scratch
    row in one window of the launch before the one that reads it; a window
    holds at most ``SL_OUT`` outputs from at most ``SL_MAX_IN`` input rows
    of the launch's span, its ops on its own slots; the inverse is one
    launch, and each forward launch's band is the next launch's span."""
    passes = TSM.span_passes(s, levels, skip, inverse)
    if inverse:
        assert len(passes) == 1
    final, span = [], s
    for windows, band in passes:
        scratch = []
        for ins, prog, outs in windows:
            assert len(outs) <= TSM.SL_OUT and len(ins) <= TSM.SL_MAX_IN
            assert len(set(ins)) == len(ins) and all(
                0 <= r < span for r in ins)
            assert all(0 <= i < len(ins) and 0 <= j < len(ins)
                       for _, i, j in prog)
            for sl, r in outs:
                assert 0 <= sl < len(ins)
                (final if r >= 0 else scratch).append(r)
        assert sorted(-1 - r for r in scratch) == list(range(band))
        span = band
    assert band == 0
    assert sorted(final) == list(range(s))


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("skip", [True, False], ids=["skip", "noskip"])
@pytest.mark.parametrize("s,levels", [
    (s, lv) for s in SPANS for lv in (1, 3, 5, 9, "auto")] + [
    (LONGEST, lv) for lv in (3, 9, "auto")])
def test_span_windows_are_the_plain_transform(s, levels, skip, inverse):
    """The Haar link's windows run in PyTorch (then the level split, where
    the forward has one) give ``span_transform_plain``'s bits: single in
    f32 without a bias, and the dual with both biases in bf16."""
    levels = _auto(s) if levels == "auto" else levels
    passes = TSM.span_passes(s, levels, skip, inverse)
    g, u, b = _operands(s, 3, True, seed=s + levels)
    kw = dict(transform="dwt", levels=levels, skip_first=skip,
              inverse=inverse)
    both = _run_windows(torch.cat([g, u], dim=-1), passes, s)
    tg, tu = both[..., :3], both[..., 3:]
    assert torch.equal(_epilogue(tg, None, None, None, torch.float32),
                       TSM.span_transform_plain(g, **kw))
    assert torch.equal(
        _epilogue(tg, tu, b, -b, torch.bfloat16),
        TSM.span_transform_plain(g, u, b, -b, out_dtype=torch.bfloat16,
                                 **kw))


@pytest.mark.parametrize("s,levels,skip", [
    (129, 3, True), (641, 9, True), (2048, 5, False), (300, "auto", True)])
def test_span_inverse_matches_reference(s, levels, skip):
    """The inverse link's windows equal the reference's ``_seq_inv``
    (``src/repro/kernels/stamp_matmul.py``) under ``jax.jit`` bit for
    bit."""
    levels = _auto(s) if levels == "auto" else levels
    y = np.random.default_rng(s).standard_normal((2, s, 8)).astype(
        np.float32)
    want = jax.jit(functools.partial(_seq_inv, kind="dwt", levels=levels,
                                     skip_first=skip))(jnp.asarray(y))
    got = _run_windows(torch.from_numpy(y),
                       TSM.span_passes(s, levels, skip, True), s)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _run_wht(x, x_up, bias, bias_up, s, skip, itemsize, out_dtype):
    """The WHT link as the card runs it, in PyTorch: each launch of
    ``span_wht_plan`` gathers its tiles from the span's power-of-two block
    (element j of tile t of batch group z at z·(p / groups) + t·tmul +
    j·istride), runs the tile's stages as the plain WHT does and scatters
    them back (every position once); the last scales by f32(1/√p) and
    applies the epilogue; the rows around the block take the same epilogue
    in the first launch."""
    b, _, n = x.shape
    off = int(skip)
    p = T.largest_pow2(s - off)
    out = torch.full((b, s, n), float("nan"))
    plan = TSM.span_wht_plan(s, n, skip, x_up is not None, itemsize,
                             torch.finfo(out_dtype).bits // 8)
    assert plan[0].first and plan[-1].last and \
        sum(st.T.bit_length() - 1 for st in plan) == p.bit_length() - 1
    blocks = [v[:, off:off + p].float() for v in (x, x_up) if v is not None]
    for st in plan:
        idx = (torch.arange(st.groups)[:, None, None] * (p // st.groups)
               + torch.arange(st.tiles)[None, :, None] * st.tmul
               + torch.arange(st.T)[None, None, :] * st.istride)
        assert torch.equal(idx.flatten().sort().values, torch.arange(p))
        for k, blk in enumerate(blocks):
            tile = blk[:, idx]                 # (b, groups, tiles, T, n)
            h = 1
            while h < st.T:
                sh = tile.reshape(*tile.shape[:3], st.T // (2 * h), 2, h, n)
                a, c = sh[..., 0, :, :], sh[..., 1, :, :]
                tile = torch.stack([a + c, a - c], dim=-3).reshape(
                    tile.shape)
                h *= 2
            blk = blk.clone()
            blk[:, idx] = tile
            if st.last:
                blk = blk * torch.tensor(recip32(np.sqrt(p)))
            blocks[k] = blk
    out[:, off:off + p] = _epilogue(blocks[0], blocks[1] if len(blocks) > 1
                                    else None, bias, bias_up,
                                    torch.float32)
    # the first launch's blocks of tile 0 write the rows around the block:
    # row k of the s - p at relative row k - off (k < off) or k + p - off
    crows = [k - off if k < off else k + p - off for k in range(s - p)]
    rows = [off + r for r in crows]
    assert sorted(rows + list(range(off, off + p))) == list(range(s))
    out[:, rows] = _epilogue(x[:, rows].float(), None if x_up is None else
                             x_up[:, rows].float(), bias, bias_up,
                             torch.float32)
    return out.to(out_dtype)


@pytest.mark.parametrize("s,skip,dual,itemsize", [
    (129, True, False, 4), (300, False, True, 4), (1025, True, False, 2),
    (2049, True, True, 4), (4097, True, True, 4), (8193, True, False, 4),
    (4097, False, False, 2), (641, True, True, 2)])
def test_span_wht_plan_is_the_plain_transform(s, skip, dual, itemsize):
    """The WHT link's launches (one where a block holds the span's block,
    else the stages over launches through f32 scratch: past 4096 rows in
    f32, 2048 for the dual or in bf16) and the rows around the block, run in
    PyTorch, give ``span_transform_plain``'s bits, forward and inverse
    alike (the WHT is its own inverse)."""
    dtype = torch.bfloat16 if itemsize == 2 else torch.float32
    g, u, b = _operands(s, 8, dual, seed=s, dtype=dtype)
    lp = T.largest_pow2(s - int(skip)).bit_length() - 1
    for bias, out_dtype in ((None, torch.float32), (b, torch.bfloat16)):
        narrow = itemsize if dual else \
            min(itemsize, torch.finfo(out_dtype).bits // 8)
        longest = TW.MAX_SMEM_BYTES // (4 * max(TW.SECTOR // narrow, 4) *
                                        (2 if dual else 1))
        plan = TSM.span_wht_plan(s, 8, skip, dual, itemsize,
                                 torch.finfo(out_dtype).bits // 8)
        assert len(plan) == (1 if 1 << lp <= longest else 2)
        want = TSM.span_transform_plain(
            g, u, bias, bias, transform="wht", levels=3, skip_first=skip,
            inverse=dual, out_dtype=out_dtype)
        assert torch.equal(_run_wht(g, u, bias, bias, s, skip, itemsize,
                                    out_dtype), want)


def test_span_wht_plan_middle_launches(monkeypatch):
    """With blocks that hold only short tiles the WHT link's stages run
    over three or more launches, the middle ones batching the high stage
    bits (``groups``); run in PyTorch they are still the plain transform,
    and a block never holds more than it may."""
    monkeypatch.setattr(TW, "MAX_SMEM_BYTES", 512)
    g, u, b = _operands(1025, 8, True, seed=3)
    plan = TSM.span_wht_plan(1025, 8, True, True, 4, 4)
    assert len(plan) >= 3 and any(st.groups > 1 for st in plan)
    for st in plan:
        assert st.T * 4 * 8 * (2 if st.last else 1) <= 512
    want = TSM.span_transform_plain(g, u, b, b, transform="wht", levels=3,
                                    skip_first=True, inverse=True)
    assert torch.equal(_run_wht(g, u, b, b, 1025, True, 4, torch.float32),
                       want)


@pytest.mark.parametrize("n,max_in,dual,want", [
    (4096, 36, False, (256, 36 * 256 * 4)),
    (4096, 44, True, (128, 44 * 128 * 8)),
    (14336, 64, True, (128, 64 * 128 * 8)),
    (40, 62, False, (64, 62 * 64 * 4)),
    (200, 32, True, (224, 32 * 224 * 8)),
    (72, 64, True, (96, 64 * 96 * 8))])
def test_span_window_plan(n, max_in, dual, want):
    """A window block's strip: as many columns as N needs up to 256, a
    multiple of 32, cut until the slots (two sets for the dual) fit 64 KB;
    the longest window program sits before them."""
    plan = TSM.span_window_plan(n, max_in, 90, dual)
    assert plan["room"] == 92
    assert (plan["cols"], plan["smem"] - 4 * plan["room"]) == want
    assert plan["smem"] - 4 * plan["room"] <= TSM.SL_SMEM


def test_span_link_takes_any_span_length():
    """The link refuses no span: past the 9557 rows a block once held for
    the dual under the DWT its plans still cover every row, and the
    wrapper's CPU path is its plain version."""
    s = 9558
    assert TSM.span_passes(s, 3, True, True)
    assert TSM.span_wht_plan(s, 40, True, True, 4, 2)[-1].last
    g, u, b = _operands(s, 4, True, seed=1)
    got = TSM.stamp_span_transform(g, u, b, None, transform="dwt",
                                   inverse=True, out_dtype=torch.bfloat16)
    assert torch.equal(got, TSM.span_transform_plain(
        g, u, b, None, transform="dwt", levels=3, skip_first=True,
        inverse=True, out_dtype=torch.bfloat16))

"""Parity of the PyTorch port's core numerics with the JAX reference on the
CPU: sequence transforms, quantizers, prepared weights, K/V page codes,
the reference-path STaMP linears — plus the port's import boundary and its
no-silent-CPU rule.

Inputs come from numpy seeds and go through both packages.  Quantizer
outputs (codes, scales, zero points) must be bit-identical: both sides use
min-max scales with a 1e-8 floor, true division by the per-token scale and
round half to even, in the same operation order.  The reference runs its
transforms and cache quantizers compiled, where XLA turns a division by a
constant into a product with its f32 reciprocal; the port computes that
product, so those comparisons are against ``jax.jit`` of the reference.
Float outputs carry a stated tolerance."""

import ast
import functools
import os
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

from repro.core import quant as JQ
from repro.core import stamp as JS
from repro.core import transforms as JT
from repro.models import lm as JLM
from repro.serving import kvcache as JKV
from repro.serving import paged_kvcache as JPKV

from repro_torch.core import quant as TQ
from repro_torch.core import stamp as TS
from repro_torch.core import transforms as TT
from repro_torch.kernels import stamp_matmul as TSM
from repro_torch.models import lm as TLM
from repro_torch.serving import kvcache as TKV
from repro_torch.serving import paged_kvcache as TPKV

ROOT = Path(__file__).resolve().parents[1]


def _np(a):
    return np.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# transforms: the compiled reference's f32 arithmetic
# ---------------------------------------------------------------------------


def _jit(fn, **kw):
    return jax.jit(functools.partial(fn, **kw))


@pytest.mark.parametrize("n", [7, 16, 33, 128])
@pytest.mark.parametrize("skip", [False, True])
def test_haar_dwt_matches_reference(n, skip):
    """One level and every inverse: exact.  Deeper forward transforms: XLA
    on the CPU fuses the levels and contracts a level's sum of two scaled
    terms into a fused multiply-add, so they agree to a few f32 steps of
    the output's magnitude (2^-20 relative to its largest value)."""
    x = np.random.default_rng(n).standard_normal((2, n, 6)).astype(np.float32)
    for levels in (1, 2, 3):
        kw = dict(levels=levels, skip_first=skip)
        np.testing.assert_array_equal(
            _np(_jit(JT.haar_idwt, **kw)(jnp.asarray(x))),
            TT.haar_idwt(_t(x), **kw).numpy())
        a = _np(_jit(JT.haar_dwt, **kw)(jnp.asarray(x)))
        b = TT.haar_dwt(_t(x), **kw).numpy()
        if levels == 1:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(b, a, rtol=0,
                                       atol=2 ** -20 * np.abs(a).max())


@pytest.mark.parametrize("n", [7, 16, 33, 128])
@pytest.mark.parametrize("skip", [False, True])
def test_wht_matches_reference(n, skip):
    x = np.random.default_rng(n + 1).standard_normal((3, n, 4)).astype(
        np.float32)
    for fj, ft in ((JT.wht, TT.wht), (JT.iwht, TT.iwht)):
        np.testing.assert_array_equal(
            _np(_jit(fj, skip_first=skip)(jnp.asarray(x))),
            ft(_t(x), skip_first=skip).numpy())


def test_transforms_invert():
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 33, 8)).astype(np.float32))
    for kind in ("dwt", "wht"):
        y = TT.inverse_sequence_transform(
            TT.sequence_transform(x, kind, levels=3, skip_first=True), kind,
            levels=3, skip_first=True)
        torch.testing.assert_close(y, x, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# quantizers: exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq,num_hi", [(7, 4), (16, 4), (33, 8), (5, 8)])
def test_mixed_precision_quantizer_matches_reference(seq, num_hi):
    """Per-token min-max scales / zero points / codes at mixed 8/4 bits,
    including ``num_hi >= seq`` (every token at 8 bits)."""
    x = (np.random.default_rng(seq).standard_normal((2, seq, 24)) * 3
         ).astype(np.float32)
    jb = JQ.mixed_precision_bits(seq, num_hi)
    tb = TQ.mixed_precision_bits(seq, num_hi)
    js, jz = JQ.minmax_scale_offset(jnp.asarray(x), jb)
    ts, tz = TQ.minmax_scale_offset(_t(x), tb)
    np.testing.assert_array_equal(_np(js), ts.numpy())
    np.testing.assert_array_equal(_np(jz), tz.numpy())
    np.testing.assert_array_equal(
        _np(JQ.quantize(jnp.asarray(x), js, jz, jb)),
        TQ.quantize(_t(x), ts, tz, tb).numpy())
    np.testing.assert_array_equal(_np(JQ.fake_quant(jnp.asarray(x), 4)),
                                  TQ.fake_quant(_t(x), 4).numpy())


@pytest.mark.parametrize("transform", ["dwt", "wht"])
@pytest.mark.parametrize("seq,num_hi", [(7, 4), (33, 4), (16, 64)])
def test_transform_quantize_codes_exact(transform, seq, num_hi):
    """K1's plain version against the reference's ``_transform_quantize``
    math, compiled as the kernel is (one-level DWT or the WHT; per-token
    mixed-precision scale / zp; signed codes)."""
    x = (np.random.default_rng(seq).standard_normal((2, seq, 40)) * 2
         ).astype(np.float32)
    kw = dict(transform=transform, levels=1, skip_first=True, num_hi=num_hi,
              hi_bits=8, lo_bits=4)
    qx, sx, zx = TSM.transform_quantize_plain(_t(x), **kw)

    @jax.jit
    def reference(a):
        tx = JT.sequence_transform(a, transform, levels=1, skip_first=True)
        bits = JQ.mixed_precision_bits(seq, num_hi)
        s, z = JQ.minmax_scale_offset(tx, bits)
        return JQ.quantize(tx, s, z, bits), s, z

    q, s, z = reference(jnp.asarray(x))
    np.testing.assert_array_equal(qx.numpy(),
                                  _np(q - 128.0).astype(np.int8).reshape(
                                      -1, 40))
    np.testing.assert_array_equal(sx.numpy(), _np(s).reshape(-1))
    np.testing.assert_array_equal(zx.numpy(), _np(z - 128.0).reshape(-1))


def test_prepare_linear_and_pack_weight_exact():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((48, 40)).astype(np.float32)
    w[:, 0] = np.abs(w[:, 0])            # a one-sided channel
    jp = JS.prepare_linear(jnp.asarray(w))
    tp = TS.prepare_linear(_t(w))
    for a, b in ((jp.qw, tp.qw), (jp.sw, tp.sw), (jp.zw, tp.zw)):
        np.testing.assert_array_equal(_np(a), b.numpy())
    # the column sums the kernels' epilogue reads, kept with the codes
    assert tp.qw_sum.dtype == torch.int32
    np.testing.assert_array_equal(
        tp.qw_sum.numpy(), _np(jp.qw).astype(np.int64).sum(0, keepdims=True))
    jw = JLM.pack_weight(jnp.asarray(w))
    tw = TLM.pack_weight(_t(w))
    for k in ("q", "scale", "zp"):
        np.testing.assert_array_equal(_np(jw[k]), tw[k].numpy())
    np.testing.assert_array_equal(
        _np(JLM._dequant_packed(jw, jnp.float32)),
        TLM._dequant_packed(tw, torch.float32).numpy())


# ---------------------------------------------------------------------------
# reference-path STaMP linears (f32 tolerance: same math, matmul order)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq", [7, 16])
def test_stamp_linear_reference_path(seq):
    rng = np.random.default_rng(seq)
    x = rng.standard_normal((2, seq, 32)).astype(np.float32)
    wg = rng.standard_normal((32, 24)).astype(np.float32) / 6
    wu = rng.standard_normal((32, 24)).astype(np.float32) / 6
    b = rng.standard_normal((24,)).astype(np.float32)
    jcfg = JS.StampConfig(num_hi_tokens=4)
    tcfg = TS.StampConfig(num_hi_tokens=4)
    np.testing.assert_allclose(
        _np(JS.stamp_linear(jnp.asarray(x), jnp.asarray(wg), jnp.asarray(b),
                            jcfg)),
        TS.stamp_linear(_t(x), _t(wg), _t(b), tcfg).numpy(),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        _np(JS.stamp_dual_linear(jnp.asarray(x), jnp.asarray(wg),
                                 jnp.asarray(wu), jcfg)),
        TS.stamp_dual_linear(_t(x), _t(wg), _t(wu), tcfg).numpy(),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        _np(JS.stamp_fake_quant(jnp.asarray(x), jcfg)),
        TS.stamp_fake_quant(_t(x), tcfg).numpy(), rtol=1e-5, atol=1e-5)


def test_fold_segments_and_ineligibility():
    x = torch.arange(2 * 12 * 3).reshape(2, 12, 3)
    f = TS.fold_segments(x, 4)
    assert f.shape == (6, 4, 3)
    assert torch.equal(TS.unfold_segments(f, 2), x)
    with pytest.raises(ValueError):
        TS.fold_segments(x, 5)
    for cfg in (TS.StampConfig(), TS.StampConfig(execution="fused"),
                TS.StampConfig(execution="fused", hi_bits=16)):
        jcfg = JS.StampConfig(execution=cfg.execution, hi_bits=cfg.hi_bits)
        assert TS.fused_ineligibility(cfg) == JS.fused_ineligibility(jcfg)


# ---------------------------------------------------------------------------
# K/V page codes: exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block_size", [4, 16])
def test_write_ragged_codes_exact(block_size):
    """The same K/V tokens scattered by the reference (compiled, as its
    steps run) and the port land as identical int8 / int4-nibble codes and
    f16 scale / zero points."""
    kvh, hd, t = 2, 16, 23
    cfg_j = JPKV.PagedCacheConfig(block_size=block_size, num_lo_blocks=12,
                                  num_hi_blocks=5, max_blocks_per_seq=8,
                                  quant=JKV.KVCacheConfig(num_hi=16))
    cfg_t = TPKV.PagedCacheConfig(block_size=block_size, num_lo_blocks=12,
                                  num_hi_blocks=5, max_blocks_per_seq=8,
                                  quant=TKV.KVCacheConfig(num_hi=16))
    rng = np.random.default_rng(block_size)
    k = (rng.standard_normal((t, kvh, hd)) * 2).astype(np.float32)
    v = rng.standard_normal((t, kvh, hd)).astype(np.float32)
    pos = np.arange(t)
    pages = np.where(pos < 16, 1 + pos // block_size,
                     1 + (pos - 16) // block_size).astype(np.int32)
    pages[-2:] = 0                                     # pads → null page
    offs = (np.where(pos < 16, pos, pos - 16) % block_size).astype(np.int32)
    is_hi = pos < 16
    je = {k_: v_[0] for k_, v_ in JPKV.init_pools(1, kvh, hd, cfg_j).items()}
    je = jax.jit(functools.partial(JPKV.write_ragged, cfg=cfg_j))(
        je, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pages),
        jnp.asarray(offs), jnp.asarray(is_hi))
    te = TPKV.init_pools(kvh, hd, cfg_t, device="cpu")
    TPKV.write_ragged(te, _t(k), _t(v), _t(pages), _t(offs), _t(is_hi),
                      cfg_t)
    assert set(je) == set(te)
    for name in je:
        a, b = _np(je[name]), te[name].numpy()
        # the null page (index 0) holds whichever pad write landed last
        np.testing.assert_array_equal(a[1:], b[1:], err_msg=name)


def test_allocator_prefix_and_swap_round_trip():
    cfg = TPKV.PagedCacheConfig(block_size=4, num_lo_blocks=8,
                                num_hi_blocks=3, max_blocks_per_seq=4,
                                quant=TKV.KVCacheConfig(num_hi=4))
    alloc = TPKV.BlockAllocator(cfg)
    hi, lo = [alloc.alloc_hi()], [alloc.alloc_lo(), alloc.alloc_lo()]
    prompt = np.arange(12, dtype=np.int32)
    assert alloc.register_prefix(prompt, 12, hi, lo) == 3
    m = alloc.lookup_prefix(prompt, 10, 2)
    assert m.matched == 10 and m.cow == ("lo", 1)
    assert alloc.ref_count("lo", lo[1]) == 2
    with pytest.raises(ValueError):
        alloc.release([0], [])
    pools = [TPKV.init_pools(2, 8, cfg, device="cpu") for _ in range(2)]
    pools[1]["k_lo"][lo[0]] = 7
    saved = TPKV.extract_pages(pools, hi, lo)
    fresh = [TPKV.init_pools(2, 8, cfg, device="cpu") for _ in range(2)]
    TPKV.insert_pages(fresh, saved, [2], [5, 6])
    assert int(fresh[1]["k_lo"][5].max()) == 7
    saved[1]["k_lo"][0, 0, 0, 0] ^= 1
    with pytest.raises(TPKV.SwapCorruption):
        TPKV.insert_pages(fresh, saved, [2], [5, 6])


# ---------------------------------------------------------------------------
# the port's boundary: no JAX, no repro; no silent CPU
# ---------------------------------------------------------------------------


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.name} imports {name}"


def test_serve_import_leaves_jax_out():
    code = ("import sys; import repro_torch.launch.serve, chip_smoke; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]; print(bad); assert not bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ,
                              "PYTHONPATH": f"{ROOT / 'src'}:{ROOT}"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_refuse_a_missing_card(monkeypatch):
    """Without CUDA the entry points raise unless the CPU is asked for."""
    from repro_torch.configs import get_reduced
    from repro_torch.core.ptq import calibrate_and_quantize
    from repro_torch.launch import serve
    from repro_torch.serving.engine import PagedServingEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced("llama3-8b")
    with pytest.raises(RuntimeError, match="CUDA"):
        TLM.init_params(cfg)
    params = TLM.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        calibrate_and_quantize(params, [], cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedServingEngine(params, cfg, TLM.ServeConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--reduced"])

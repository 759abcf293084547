"""Parity of the port's paper numerics with the JAX reference on the CPU:
the synthetic data, the straight-through rounding, RTN weight quantization
with its range search, the 2-D DWT, DCT and KLT, per-block STaMP, the
feature-transform baselines, calibration, bit allocation, the error bounds
and the calibration taps.

Inputs come from numpy seeds and go through both packages at small sizes.
What is held bit for bit: the data, the 17 shrink candidates, RTN codes,
scales and zero points (against the reference as its runners call it,
eagerly: under ``jax.jit`` XLA contracts the range products into FMAs and
moves a scale by up to 2 ulp, never a code or a zero point), the 2-D DWT
and its round trip, the quantizer codes after the butterfly transforms
(against ``jax.jit``, whose ``x * f32(1/√2)`` the port follows), the
Hadamard matrices, the KLT basis, SVDQuant's factors and residual codes,
``calibrate``'s ``num_hi`` and the bit allocations.  The dense DCT / KLT
products sum in the BLAS's order: their outputs are held within 1e-5
relative and at most 0.1% of their 4-bit codes one step apart.
FlatQuant-lite's Adam runs through a straight-through quantizer: its
gradient at θ = 0 is held within 1e-5, θ after three steps within 1e-4,
the gradient at every step of the port's fit within 1e-4 of the
reference's at the same θ, and both fits' end by what they achieve
(:func:`test_flatquant_lite_fit`)."""

import dataclasses
import json

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

from repro.core import bitalloc as JB
from repro.core import calibration as JC
from repro.core import error_bounds as JE
from repro.core import feature_transforms as JF
from repro.core import ptq as JPTQ
from repro.core import quant as JQ
from repro.core import stamp as JS
from repro.core import transforms as JT
from repro.data import pipeline as JD
from repro.models import lm as JLM
from repro.models.config import ModelConfig as JModelConfig

from repro_torch.core import bitalloc as TB
from repro_torch.core import calibration as TC
from repro_torch.core import error_bounds as TE
from repro_torch.core import feature_transforms as TF
from repro_torch.core import ptq as TPTQ
from repro_torch.core import quant as TQ
from repro_torch.core import stamp as TS
from repro_torch.core import transforms as TT
from repro_torch.data import pipeline as TD
from repro_torch.models import lm as TLM
from repro_torch.models.config import ModelConfig as TModelConfig

RTOL = 1e-5
HW = (8, 8)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _eq(a, b) -> None:
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _acts(seed: int, shape=(2, 64, 32), scale=2.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) *
            scale).astype(np.float32)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,axis", [((2, 16, 8), -2), ((3, 5, 7), 0),
                                        ((4, 9), -1)])
def test_ar_features_bit_equal(shape, axis):
    _eq(JD.ar_features(shape, rho=0.9, seed=3, axis=axis),
        TD.ar_features(shape, rho=0.9, seed=3, axis=axis))


def test_ar_grid_features_and_iterator_bit_equal():
    _eq(JD.ar_grid_features(2, (4, 6), 8, rho=0.8, seed=5),
        TD.ar_grid_features(2, (4, 6), 8, rho=0.8, seed=5))
    jit = JD.DataIterator(JD.DataConfig(vocab_size=64, seq_len=12,
                                        global_batch=2, seed=4))
    tit = TD.DataIterator(TD.DataConfig(vocab_size=64, seq_len=12,
                                        global_batch=2, seed=4))
    for _ in range(3):
        a, b = next(jit), next(tit)
        _eq(a["tokens"], b["tokens"])
        _eq(a["labels"], b["labels"])
    assert tit.state() == jit.state() == {"step": 3}
    tit.restore({"step": 1})
    _eq(next(tit)["tokens"], JD.markov_batch(jit.cfg, 1)["tokens"])


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------


def test_round_ste_rounds_half_to_even_with_identity_gradient():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.3, -0.7], np.float32)
    c = np.arange(1, 9, dtype=np.float32)
    jg = jax.jit(jax.grad(lambda a: jnp.sum(JQ._round_ste(a) * c)))(
        jnp.asarray(x))
    tx = _t(x).requires_grad_(True)
    y = TQ.round_ste(tx)
    (y * _t(c)).sum().backward()
    _eq(np.asarray(JQ._round_ste(jnp.asarray(x))), y.detach().numpy())
    _eq(jg, tx.grad.numpy())


def test_fake_quant_gradient_matches_reference():
    """The straight-through path of ``fake_quant`` (min / max ties share
    the gradient on both sides)."""
    x = _acts(1, (2, 8, 16))
    jg = jax.jit(jax.grad(lambda a: jnp.sum(
        JQ.fake_quant(a, 4, axis=-1) ** 2)))(jnp.asarray(x))
    tx = _t(x).requires_grad_(True)
    (TQ.fake_quant(tx, 4, axis=-1, compiled=True) ** 2).sum().backward()
    assert _rel(jg, tx.grad.numpy()) <= RTOL


@pytest.mark.parametrize("bits", [4, 8])
def test_fake_quant_per_block_and_to_int(bits):
    x = _acts(2)
    _eq(JQ.fake_quant_per_block(jnp.asarray(x), bits, 16),
        TQ.fake_quant_per_block(_t(x), bits, 16))
    q = np.array([-300.0, -128.0, 0.0, 127.0, 128.0, 255.0], np.float32)
    _eq(JQ.to_int(jnp.asarray(q), bits), TQ.to_int(_t(q), bits))
    _eq(JQ.to_int(jnp.asarray(q), 16), TQ.to_int(_t(q), 16))
    with pytest.raises(ValueError):
        TQ.fake_quant_per_block(_t(x), bits, 20)


def test_shrink_candidates_bit_equal():
    _eq(jnp.linspace(0.6, 1.0, 17), TQ.shrink_candidates(17, 0.6))
    _eq(jax.jit(lambda: jnp.linspace(0.5, 1.0, 9))(),
        TQ.shrink_candidates(9, 0.5))


def _rtn_jit(w, bits):
    r = JQ.rtn_quantize_weight(w, bits=bits, axis=0)
    return r.q, r.scale, r.zero_point


@pytest.mark.parametrize("bits,scale", [(2, 3.0), (4, 1.0), (4, 0.05),
                                        (8, 1.0)])
def test_rtn_quantize_weight_bit_equal(bits, scale):
    """Codes, scales and zero points equal the reference's as its runners
    call it; 8-bit codes above 127 saturate in int8 storage as the
    reference's conversion does.  Under ``jax.jit`` the codes and zero
    points are the same and a scale at most 2 ulp away."""
    w = (np.random.default_rng(bits * 31).standard_normal((64, 48)) *
         scale).astype(np.float32)
    je = JQ.rtn_quantize_weight(jnp.asarray(w), bits=bits, axis=0)
    tw = TQ.rtn_quantize_weight(_t(w), bits=bits, axis=0)
    _eq(je.q, tw.q)
    _eq(je.scale, tw.scale)
    _eq(je.zero_point, tw.zero_point)
    assert tw.q.dtype == torch.int8 and tw.bits == bits
    _eq(je.dequant(jnp.float32), tw.dequant(torch.float32))
    jq, js, jz = jax.jit(_rtn_jit, static_argnums=1)(jnp.asarray(w), bits)
    _eq(jq, tw.q)
    _eq(jz, tw.zero_point)
    ulp = np.abs(np.asarray(js).view(np.int32) -
                 tw.scale.numpy().view(np.int32))
    assert ulp.max() <= 2


def test_rtn_quantize_weight_other_axis():
    w = _acts(4, (24, 40))
    jq, js, jz = jax.jit(lambda a: (lambda r: (r.q, r.scale, r.zero_point))(
        JQ.rtn_quantize_weight(a, bits=4, axis=1)))(jnp.asarray(w))
    tw = TQ.rtn_quantize_weight(_t(w), bits=4, axis=1)
    _eq(jq, tw.q)
    _eq(jz, tw.zero_point)
    assert _rel(js, tw.scale) <= 2 ** -22


def test_quant_error_and_sqnr():
    x, y = _acts(5), _acts(6, scale=0.1)
    q = x + y
    je, js = jax.jit(lambda a, b: (JQ.quant_error(a, b), JQ.sqnr_db(a, b)))(
        jnp.asarray(x), jnp.asarray(q))
    assert _rel(je, TQ.quant_error(_t(x), _t(q))) <= 1e-6
    assert _rel(js, TQ.sqnr_db(_t(x), _t(q))) <= 1e-6


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------


GRIDS = [((8, 8), 3), ((6, 10), 3), ((16, 8), 5)]


def _grid_inputs(hw):
    x = _acts(7, (2, hw[0] * hw[1], 12))
    return x, np.swapaxes(x, 1, 2).copy()   # the sequence on the last axis


@pytest.fixture(scope="module")
def ref_dwt_2d():
    """``jax.jit`` of the reference's 2-D DWT at every grid of ``GRIDS``
    (along the sequence and along the last axis), then of its inverse on
    those coefficients: two compiled programs."""
    xs = [tuple(map(jnp.asarray, _grid_inputs(hw))) for hw, _ in GRIDS]
    fwd = jax.jit(lambda xs: [(JT.haar_dwt_2d(a, hw, lv),
                               JT.haar_dwt_2d(b, hw, lv, axis=-1))
                              for (a, b), (hw, lv) in zip(xs, GRIDS)])(xs)
    inv = jax.jit(lambda ys: [JT.haar_idwt_2d(y, hw, lv)
                              for y, (hw, lv) in zip(ys, GRIDS)])(
        [y for y, _ in fwd])
    return fwd, inv


@pytest.mark.parametrize("case", range(len(GRIDS)))
def test_haar_dwt_2d_bit_equal(ref_dwt_2d, case):
    """Forward against ``jax.jit`` of the reference, the round trip bit-equal
    to the reference's inverse of the same coefficients, and exact enough
    to give the input back."""
    hw, levels = GRIDS[case]
    _eq(JT._subband_order(*hw, levels), TT.subband_order(*hw, levels))
    x, xt = _grid_inputs(hw)
    (jy, jt), jz = ref_dwt_2d[0][case], ref_dwt_2d[1][case]
    ty = TT.haar_dwt_2d(_t(x), hw, levels)
    _eq(jy, ty)
    _eq(jt, TT.haar_dwt_2d(_t(xt), hw, levels, axis=-1))
    _eq(jz, TT.haar_idwt_2d(ty, hw, levels))
    assert _rel(x, jz) <= 1e-6
    with pytest.raises(ValueError):
        TT.haar_dwt_2d(_t(x[:, :-1]), hw, levels)


@pytest.mark.parametrize("skip_first", [False, True])
def test_dct_within_tolerance(skip_first):
    _eq(JT.dct_matrix(24), TT.dct_matrix(24))
    x = _acts(8, (2, 25, 16))
    jy = jax.jit(lambda a: JT.dct(a, skip_first=skip_first))(jnp.asarray(x))
    ty = TT.dct(_t(x), skip_first=skip_first)
    assert _rel(jy, ty) <= RTOL
    assert _rel(jax.jit(lambda a: JT.idct(a, skip_first=skip_first))(jy),
                TT.idct(ty, skip_first=skip_first)) <= RTOL


def _autocorr(seed: int, s: int = 32, d: int = 16) -> np.ndarray:
    st = JC.SiteStats.empty(s, d)
    st.update(jnp.asarray(JD.ar_features((4, s, d), rho=0.9, seed=seed)))
    return st.autocorr


def test_klt_basis_bit_equal_and_apply_matrix():
    a = _autocorr(9)
    jb, tb = JT.klt_basis(a), TT.klt_basis(a)
    _eq(jb, tb)
    x = _acts(10, (2, 32, 8))
    for inverse in (False, True):
        assert _rel(jax.jit(lambda v: JT.apply_matrix(v, jb,
                                                      inverse=inverse))(
            jnp.asarray(x)), TT.apply_matrix(_t(x), tb,
                                             inverse=inverse)) <= RTOL


def test_sequence_transform_dispatch():
    x = _t(_acts(11, (1, 64, 4)))
    basis = TT.klt_basis(np.eye(64))
    for kind, kw in (("dwt2d", dict(hw=HW)), ("klt", dict(basis=basis)),
                     ("dct", {}), ("identity", {})):
        y = TT.sequence_transform(x, kind, **kw)
        assert _rel(x, TT.inverse_sequence_transform(y, kind, **kw)) <= 1e-5
    for kind in ("dwt2d", "klt"):
        with pytest.raises(ValueError):
            TT.sequence_transform(x, kind)
        with pytest.raises(ValueError):
            TT.inverse_sequence_transform(x, kind)
    with pytest.raises(ValueError):
        TT.sequence_transform(x, "fft")


# ---------------------------------------------------------------------------
# STaMP: codes after each transform, token and block granularity
# ---------------------------------------------------------------------------


def _codes_jax(cfg, a, basis=None):
    """The transformed activation with its codes, scales and zero points
    (the program returns the transform's output, as the fused kernel
    writes its codes from it)."""
    tx = JS.apply_seq_transform(a.astype(jnp.float32), cfg, basis=basis)
    bits = cfg.bits_vector(tx.shape[-2])
    if cfg.granularity == "block":
        *lead, s, d = tx.shape
        xb = tx.reshape(*lead, s, d // cfg.block_size, cfg.block_size)
        n = (2.0 ** bits[:, None] - 1.0)[..., None]
        mn = jnp.min(xb, -1, keepdims=True)
        mx = jnp.max(xb, -1, keepdims=True)
        sc = jnp.maximum((mx - mn) / n, 1e-8)
        zp = jnp.round(-mn / sc)
        return tx, jnp.clip(jnp.round(xb / sc) + zp, 0.0, n), sc, zp
    sc, zp = JQ.minmax_scale_offset(tx, bits, axis=-1)
    return tx, JQ.quantize(tx, sc, zp, bits), sc, zp


def _codes_port(cfg, x, basis=None):
    tx = TS.apply_seq_transform(x.float(), cfg, basis=basis)
    bits = cfg.bits_vector(tx.shape[-2])
    if cfg.granularity == "block":
        *lead, s, d = tx.shape
        xb = tx.reshape(*lead, s, d // cfg.block_size, cfg.block_size)
        n = (2.0 ** bits[:, None] - 1.0)[..., None]
        mn = xb.amin(-1, keepdim=True)
        mx = xb.amax(-1, keepdim=True)
        sc = torch.clamp_min((mx - mn) / n, 1e-8)
        zp = torch.round(-mn / sc)
        return tx, torch.minimum(torch.clamp_min(torch.round(xb / sc) + zp,
                                                 0.0), n), sc, zp
    sc, zp = TQ.minmax_scale_offset(tx, bits, axis=-1)
    return tx, TQ.quantize(tx, sc, zp, bits), sc, zp


def _cfg_pair(kind, gran, **kw):
    kw = dict(seq_transform=kind, num_hi_tokens=8, granularity=gran,
              block_size=16, skip_first_token=kind != "dwt2d", hw=HW, **kw)
    return JS.StampConfig(**kw), TS.StampConfig(**kw)


def _basis(kind):
    if kind != "klt":
        return None, None
    b = JT.klt_basis(_autocorr(13, s=64))
    return b, TT.klt_basis(_autocorr(13, s=64))


GRANS = ["token", "block"]
BUTTERFLIES = ["dwt", "wht", "dwt2d", "none"]
DENSE = ["dct", "klt"]
CODES_X = 12


@pytest.fixture(scope="module")
def ref_codes():
    """``jax.jit`` of the reference's transform and quantizer (the
    transformed activation with its codes, scales and zero points) and of
    its round trip, for every transform × granularity, in one program."""
    jb = _basis("klt")[0]

    def codes(a):
        out = {}
        for kind in BUTTERFLIES + DENSE:
            for gran in GRANS:
                jc = _cfg_pair(kind, gran)[0]
                b = jb if kind == "klt" else None
                out[kind, gran] = (_codes_jax(jc, a, b),
                                   JS.stamp_fake_quant(a, jc, basis=b))
        return out
    return jax.jit(codes)(jnp.asarray(_acts(CODES_X)))


@pytest.mark.parametrize("gran", GRANS)
@pytest.mark.parametrize("kind", BUTTERFLIES)
def test_stamp_codes_bit_equal(ref_codes, kind, gran):
    """The transformed activation, its codes, scales and zero points
    against ``jax.jit`` of the reference; the round trip within 1e-5 (XLA
    fuses its inverse transform with the dequantization)."""
    tc = _cfg_pair(kind, gran)[1]
    x = _t(_acts(CODES_X))
    codes, trip = ref_codes[kind, gran]
    for j, t in zip(codes, _codes_port(tc, x)):
        _eq(j, t)
    assert _rel(trip, TS.stamp_fake_quant(x, tc)) <= RTOL


@pytest.mark.parametrize("gran", GRANS)
@pytest.mark.parametrize("kind", DENSE)
def test_stamp_dense_bases_within_tolerance(ref_codes, kind, gran):
    """The dense bases: at most 0.1% of the codes one step apart, none
    further, and the round trip within 1e-5."""
    tc = _cfg_pair(kind, gran)[1]
    tb = _basis(kind)[1]
    x = _t(_acts(CODES_X))
    codes, trip = ref_codes[kind, gran]
    diff = np.abs(np.asarray(codes[1]) - _codes_port(tc, x, tb)[1].numpy())
    assert diff.max() <= 1 and diff.mean() <= 1e-3
    assert _rel(trip, TS.stamp_fake_quant(x, tc, basis=tb)) <= RTOL


def test_stamp_config_and_ineligibility():
    rot = np.eye(4, dtype=np.float32)
    cases = [dict(), dict(execution="fused"),
             dict(execution="fused", granularity="block"),
             dict(execution="fused", seq_transform="dct"),
             dict(execution="fused", seq_transform="dwt2d", hw=HW),
             dict(execution="fused", seq_transform="klt", hi_bits=16)]
    for kw in cases:
        jc, tc = JS.StampConfig(**kw), TS.StampConfig(**kw)
        for jr, tr in ((None, None), (jnp.asarray(rot), _t(rot))):
            assert TS.fused_ineligibility(tc, tr) == \
                JS.fused_ineligibility(jc, jr)
            assert TS.fused_eligible(tc, tr) == JS.fused_eligible(jc, jr)
        assert abs(tc.average_bits(200) - jc.average_bits(200)) <= 1e-6
    assert {f.name for f in dataclasses.fields(TS.StampConfig)} == \
        {f.name for f in dataclasses.fields(JS.StampConfig)}


def _linear_inputs(seed: int, s: int = 64, din: int = 32, dout: int = 24):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, s, din)) * 2).astype(np.float32)
    w = (rng.standard_normal((din, dout)) * 0.1).astype(np.float32)
    b = rng.standard_normal((dout,)).astype(np.float32)
    return x, w, b


LINEAR_CASES = ["w_quant", "klt", "feature_rot", "block", "dwt2d"]


def _linear_case(case):
    """``(config kwargs, weight, reference kwargs, port kwargs)`` of one
    reference-path case (the reference's RTN codes are drawn inside its
    program, from ``w``)."""
    _, w, _ = _linear_inputs(16)
    jkw, tkw, cfg = {}, {}, dict(num_hi_tokens=8)
    if case == "w_quant":
        tkw["w_quant"] = TQ.rtn_quantize_weight(_t(w), bits=4)
    elif case == "klt":
        cfg["seq_transform"] = "klt"
        jkw["basis"], tkw["basis"] = _basis("klt")
    elif case == "feature_rot":
        r = JF.hadamard_matrix(32)
        jkw["feature_rot"], tkw["feature_rot"] = jnp.asarray(r), _t(r)
        w = (r.T @ w).astype(np.float32)
    elif case == "block":
        cfg.update(granularity="block", block_size=16)
    else:
        cfg.update(seq_transform="dwt2d", hw=HW, skip_first_token=False)
    return cfg, w, jkw, tkw


@pytest.fixture(scope="module")
def ref_linear():
    """``jax.jit`` of the reference's reference-path linear at every case
    of ``LINEAR_CASES``, in one program."""
    x, _, b = _linear_inputs(16)
    cases = {case: _linear_case(case) for case in LINEAR_CASES}

    def linears(a):
        out = {}
        for case, (cfg, w, jkw, _) in cases.items():
            jw = jnp.asarray(w)
            if case == "w_quant":
                jkw["w_quant"], jw = JQ.rtn_quantize_weight(jw, bits=4), None
            out[case] = JS.stamp_linear(a, jw, jnp.asarray(b),
                                        JS.StampConfig(**cfg), **jkw)
        return out
    return jax.jit(linears)(jnp.asarray(x))


@pytest.mark.parametrize("case", LINEAR_CASES)
def test_stamp_linear_reference_path(ref_linear, case):
    """The reference-path STaMP linear with RTN weight codes, a KLT basis,
    a feature rotation, per-block scales or the 2-D DWT."""
    x, _, b = _linear_inputs(16)
    cfg, w, _, tkw = _linear_case(case)
    tw = None if case == "w_quant" else _t(w)
    ty = TS.stamp_linear(_t(x), tw, _t(b), TS.StampConfig(**cfg), **tkw)
    assert _rel(ref_linear[case], ty) <= RTOL


def test_stamp_dual_linear_with_basis():
    x, wg, _ = _linear_inputs(17)
    _, wu, _ = _linear_inputs(18)
    jb, tb = _basis("klt")
    jc, tc = _cfg_pair("klt", "token")
    jy = jax.jit(lambda a: JS.stamp_dual_linear(
        a, jnp.asarray(wg), jnp.asarray(wu), jc, basis=jb))(jnp.asarray(x))
    ty = TS.stamp_dual_linear(_t(x), _t(wg), _t(wu), tc, basis=tb)
    assert _rel(jy, ty) <= RTOL


@pytest.mark.parametrize("bits", [4, 8])
def test_prepare_linear_from_rtn_codes(bits):
    _, w, b = _linear_inputs(19)
    twq = TQ.rtn_quantize_weight(_t(w), bits=bits)
    jwq = JQ.QuantizedWeight(q=jnp.asarray(twq.q.numpy()),
                             scale=jnp.asarray(twq.scale.numpy()),
                             zero_point=jnp.asarray(twq.zero_point.numpy()),
                             bits=bits)
    jp = JS.prepare_linear(b=jnp.asarray(b), w_quant=jwq)
    tp = TS.prepare_linear(b=_t(b), w_quant=twq)
    _eq(jp.qw, tp.qw)
    _eq(jp.sw, tp.sw)
    _eq(jp.zw, tp.zw)
    _eq(np.asarray(jp.qw, np.int32).sum(0, keepdims=True), tp.qw_sum)
    with pytest.raises(ValueError):
        TS.prepare_linear(w_quant=dataclasses.replace(twq, bits=16))


def test_fused_stamp_linear_takes_rtn_codes():
    """A fused call with ``w_quant`` runs the RTN codes through K1 → K2
    (their plain versions here): the same bits as a call on the codes'
    prepared buffers (:func:`test_prepare_linear_from_rtn_codes` holds
    those to the reference's), and within 1e-5 of the reference's
    reference path on the same codes."""
    x, w, b = _linear_inputs(20, s=33, din=48, dout=40)
    cfg = dict(num_hi_tokens=8, execution="fused")
    jc, tc = JS.StampConfig(**cfg), TS.StampConfig(**cfg)
    twq = TQ.rtn_quantize_weight(_t(w), bits=4)
    ty = TS.stamp_linear(_t(x), None, _t(b), tc, w_quant=twq)
    _eq(ty, TS.stamp_linear(_t(x), None, None, tc,
                            prepared=TS.prepare_linear(b=_t(b),
                                                       w_quant=twq)))
    jwq = JQ.QuantizedWeight(q=jnp.asarray(twq.q.numpy()),
                             scale=jnp.asarray(twq.scale.numpy()),
                             zero_point=jnp.asarray(twq.zero_point.numpy()),
                             bits=4)
    jy = jax.jit(lambda a: JS.stamp_linear(
        a, None, jnp.asarray(b), dataclasses.replace(
            jc, execution="reference"), w_quant=jwq))(jnp.asarray(x))
    assert _rel(jy, ty) <= RTOL
    # a feature rotation keeps the call on the reference path
    r = _t(np.eye(48, dtype=np.float32))
    _eq(TS.stamp_linear(_t(x), None, _t(b), tc, w_quant=twq, feature_rot=r),
        TS.stamp_linear(_t(x), None, _t(b),
                        dataclasses.replace(tc, execution="reference"),
                        w_quant=twq))


# ---------------------------------------------------------------------------
# feature transforms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [16, 24, 64, 96])
def test_hadamard_matrix_bit_equal(d):
    _eq(JF.hadamard_matrix(d), TF.hadamard_matrix(d))


def test_random_hadamard_on_reference_signs():
    key = jax.random.PRNGKey(5)
    signs = jax.random.rademacher(key, (32,), dtype=jnp.float32)
    _eq(JF.random_hadamard(32, key), TF.random_hadamard(32, signs=_t(signs)))
    g = torch.Generator().manual_seed(5)
    r = TF.random_hadamard(32, generator=g)
    assert torch.allclose(r @ r.T, torch.eye(32), atol=1e-6)
    with pytest.raises(ValueError):
        TF.random_hadamard(32)


def test_smoothquant_and_sdcb_scales():
    rng = np.random.default_rng(21)
    a = np.abs(rng.standard_normal(32)).astype(np.float32) * 5
    w = np.abs(rng.standard_normal(32)).astype(np.float32)
    a[3] = 0.0
    assert _rel(JF.smoothquant_scales(jnp.asarray(a), jnp.asarray(w), 0.6),
                TF.smoothquant_scales(_t(a), _t(w), 0.6)) <= 1e-6
    assert _rel(JF.sdcb_scales(jnp.asarray(a), jnp.asarray(w)),
                TF.sdcb_scales(_t(a), _t(w))) <= 1e-6


def test_svdquant_decompose_bit_equal():
    w = _acts(22, (64, 48), scale=0.2)
    w[:, 3] *= 20.0
    js = JF.svdquant_decompose(jnp.asarray(w), rank=8, bits=4)
    ts = TF.svdquant_decompose(_t(w), rank=8, bits=4)
    _eq(js.l1, ts.l1)
    _eq(js.l2, ts.l2)
    _eq(js.residual.q, ts.residual.q)
    _eq(js.residual.scale, ts.residual.scale)
    _eq(js.residual.zero_point, ts.residual.zero_point)
    assert _rel(js.dequant(jnp.float32), ts.dequant(torch.float32)) <= RTOL


def _flat_inputs():
    rng = np.random.default_rng(23)
    x = JD.ar_features((96, 32), rho=0.5, seed=23, axis=0)
    x[:, :2] *= 6.0
    w = (rng.standard_normal((32, 16)) * 0.2).astype(np.float32)
    return x, w


def _jax_flat_loss(x, w, bits=4):
    """The reference's FlatQuant-lite loss (its closure in
    ``flatquant_lite_fit``)."""
    h = jnp.asarray(JF.hadamard_matrix(x.shape[-1]))
    ref = x @ w

    def loss(theta):
        r = jnp.exp(theta)[:, None] * h
        r_inv = h.T * jnp.exp(-theta)[None, :]
        tq = JQ.fake_quant(x @ r, bits, axis=-1)
        return jnp.mean(((tq @ r_inv) @ w - ref) ** 2)
    return loss


def _port_flat_grad(theta, tx, tw, h):
    th = theta.clone().requires_grad_(True)
    TF.flatquant_loss(th, tx, tw, h, tx @ tw, 4).backward()
    return th.grad


def test_flatquant_lite_fit():
    """The gradient at θ = 0 within 1e-5 of ``jax.grad``; ``R`` and ``R⁻¹``
    after 3 Adam steps within 1e-4; along the port's own 100 steps the
    reference's gradient at the port's θ within 1e-4 of the port's at
    every step; and both fits (the port's and the reference's) end below
    their start (R = H) and below half the loss without a rotation, by
    the reference's loss.  The two 100-step fits do not end at one loss:
    Adam's normalized steps turn the gradients' f32 rounding differences
    (the products sum in other orders) into other trajectories, and at
    this input their final losses are 1.2% apart (``fits`` below)."""
    x, w = _flat_inputs()
    jx, jw, tx, tw = jnp.asarray(x), jnp.asarray(w), _t(x), _t(w)
    jloss = _jax_flat_loss(jx, jw)
    jgrad = jax.jit(jax.grad(jloss))
    h = torch.tensor(TF.hadamard_matrix(32))
    theta = torch.zeros(32)
    assert _rel(jgrad(jnp.zeros(32)),
                _port_flat_grad(theta, tx, tw, h).numpy()) <= 1e-5
    jr, jri = JF.flatquant_lite_fit(jx, jw, bits=4, steps=3)
    tr, tri = TF.flatquant_lite_fit(tx, tw, bits=4, steps=3)
    assert _rel(jr, tr) <= 1e-4 and _rel(jri, tri) <= 1e-4
    m, v = torch.zeros(32), torch.zeros(32)
    for t in range(1, 101):             # flatquant_lite_fit's loop
        g = _port_flat_grad(theta, tx, tw, h)
        assert _rel(jgrad(jnp.asarray(theta.numpy())), g.numpy()) <= 1e-4
        m, v = 0.9 * m + 0.1 * g, 0.999 * v + 0.001 * g * g
        mh, vh = TQ.fdiv(m, 1 - 0.9 ** t), TQ.fdiv(v, 1 - 0.999 ** t)
        theta = theta - 1e-2 * mh / (torch.sqrt(vh) + 1e-8)
    tr, tri = TF.flatquant_lite_fit(tx, tw, bits=4)
    _eq(tr, torch.exp(theta)[:, None] * h)
    # the reference's loss of a rotation and its inverse, one program
    loss_of = jax.jit(lambda r, r_inv: jnp.mean(
        ((JQ.fake_quant(jx @ r, 4) @ r_inv) @ jw - jx @ jw) ** 2))
    jh, eye = jnp.asarray(h.numpy()), jnp.eye(32)
    start = float(loss_of(jh, jh.T))             # R = H
    plain = float(loss_of(eye, eye))             # no rotation
    fits = [float(loss_of(r, r_inv))
            for r, r_inv in (JF.flatquant_lite_fit(jx, jw, bits=4),
                             (jnp.asarray(tr), jnp.asarray(tri)))]
    assert max(fits) < start and max(fits) < plain / 2


FIT_TRAJECTORY = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core import feature_transforms as JF
from repro.core import quant as JQ
from repro.data import pipeline as JD
rng = np.random.default_rng(23)
x = JD.ar_features((96, 32), rho=0.5, seed=23, axis=0)
x[:, :2] *= 6.0
w = (rng.standard_normal((32, 16)) * 0.2).astype(np.float32)
jx, jw = jnp.asarray(x), jnp.asarray(w)
h = jnp.asarray(JF.hadamard_matrix(32))
ref = jx @ jw


def loss(theta):
    r = jnp.exp(theta)[:, None] * h
    r_inv = h.T * jnp.exp(-theta)[None, :]
    return jnp.mean(((JQ.fake_quant(jx @ r, 4, axis=-1) @ r_inv) @ jw
                     - ref) ** 2)


grad = jax.jit(jax.grad(loss))
theta = jnp.zeros((32,), jnp.float32)
m, v, out = jnp.zeros_like(theta), jnp.zeros_like(theta), []
for t in range(1, 101):      # flatquant_lite_fit's loop, theta kept a step
    g = grad(theta)
    m = 0.9 * m + 0.1 * g
    v = 0.999 * v + 0.001 * g * g
    theta = theta - 1e-2 * (m / (1 - 0.9**t)) / (jnp.sqrt(v / (1 - 0.999**t))
                                                 + 1e-8)
    out.append(np.asarray(theta).tolist())
print(json.dumps(out))
"""


def test_flatquant_fits_part_at_a_code_flip():
    """Where the two 100-step fits part (ROADMAP §3): the reference's θ
    trajectory is the same with and without XLA's excess precision (the
    fit is all f32); the port's follows it within 1e-6 until one step,
    where θ jumps apart (measured: step 58, 7.6e-7 before it, 2.4e-4
    after) because one 4-bit code of ``X·R`` lies within that gap of a
    rounding boundary: the reference's own compiled quantizer gives
    another code at the port's θ than at its own."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    runs = []
    for flags in ("", "--xla_allow_excess_precision=false"):
        p = subprocess.run(
            [sys.executable, "-c", FIT_TRAJECTORY],
            env=dict(os.environ, PYTHONPATH=str(root / "src"),
                     JAX_PLATFORMS="cpu", XLA_FLAGS=flags),
            capture_output=True, text=True, timeout=300)
        assert p.returncode == 0, p.stderr[-2000:]
        runs.append(np.array(json.loads(p.stdout.strip().splitlines()[-1]),
                             np.float32))
    assert np.array_equal(runs[0], runs[1])
    x, w = _flat_inputs()
    tx, tw = _t(x), _t(w)
    h = torch.tensor(TF.hadamard_matrix(32))
    theta, m, v, port = torch.zeros(32), torch.zeros(32), torch.zeros(32), []
    for t in range(1, 101):             # flatquant_lite_fit's loop
        g = _port_flat_grad(theta, tx, tw, h)
        m, v = 0.9 * m + 0.1 * g, 0.999 * v + 0.001 * g * g
        mh, vh = TQ.fdiv(m, 1 - 0.9 ** t), TQ.fdiv(v, 1 - 0.999 ** t)
        theta = theta - 1e-2 * mh / (torch.sqrt(vh) + 1e-8)
        port.append(theta.numpy().copy())
    gap = np.abs(runs[0] - np.array(port)).max(axis=1)
    part = int(np.argmax(gap > 1e-5))           # the step index that parts
    assert 0 < part and gap[part - 1] <= 1e-6 < 1e-4 <= gap[part], gap
    jh = jnp.asarray(h.numpy())

    @jax.jit
    def codes(th):
        t = jnp.asarray(x) @ (jnp.exp(th)[:, None] * jh)
        s, z = JQ.minmax_scale_offset(t, 4)
        return JQ.quantize(t, s, z, 4)
    flips = [int((codes(runs[0][i - 1]) != codes(port[i - 1])).sum())
             for i in (part - 1, part)]
    assert flips == [0, 1], (part + 1, flips)


@pytest.mark.parametrize("name", ["rtn", "quarot", "hadamard", "smoothquant",
                                  "sdcb", "vidit-q", "svdquant"])
def test_build_feature_transform(name):
    x, w = _flat_inputs()
    key = jax.random.PRNGKey(7)
    signs = jax.random.rademacher(key, (32,), dtype=jnp.float32)
    js = JF.build_feature_transform(name, 32, x_calib=jnp.asarray(x),
                                    w=jnp.asarray(w), key=key)
    ts = TF.build_feature_transform(name, 32, x_calib=_t(x), w=_t(w),
                                    signs=_t(signs))
    assert _rel(js.apply_to_activation(jnp.asarray(x)),
                ts.apply_to_activation(_t(x))) <= 1e-6
    assert _rel(js.fold_into_weight(jnp.asarray(w)),
                ts.fold_into_weight(_t(w))) <= 1e-6
    if name == "hadamard":
        assert _rel(JF.fold_feature_transform(jnp.asarray(w), js.r),
                    TF.fold_feature_transform(_t(w), ts.r)) <= 1e-6
    with pytest.raises(ValueError):
        TF.build_feature_transform("smoothquant", 32)
    with pytest.raises(ValueError):
        TF.build_feature_transform("gptq", 32)


# ---------------------------------------------------------------------------
# calibration, bit allocation, error bounds, calibration taps
# ---------------------------------------------------------------------------


def test_energy_profile():
    """The statistics of a latent grid and the energy under the transforms
    this slice adds to the profile (the KLT's rows, the 2-D DWT, the
    DCT)."""
    x = JD.ar_grid_features(4, HW, 8, seed=24)
    js, ts = JC.SiteStats.empty(64, 8), TC.SiteStats.empty(64, 8)
    js.update(jnp.asarray(x))
    ts.update(_t(x))
    _eq(js.autocorr, ts.autocorr)
    _eq(js.act_absmax, ts.act_absmax)
    _eq(js.klt(), ts.klt())
    for kind in ("klt", "dct"):
        assert _rel(js.energy_profile(kind), ts.energy_profile(kind)) <= RTOL
    # the 2-D DWT's profile by the reference's formula, its L compiled
    l2d = jax.jit(lambda e: JT.haar_dwt_2d(e, HW, 3))(jnp.eye(64)[None])[0]
    assert _rel(np.einsum("is,st,it->i", np.asarray(l2d), js.autocorr, l2d),
                ts.energy_profile("dwt2d", levels=3, hw=HW)) <= RTOL


def test_calibrate():
    sites = {name: [JD.ar_features((2, 32, 8), seed=seed + i)
                    for i in range(3)]
             for name, seed in (("qkv", 30), ("down", 40))}
    jr = JC.calibrate({k: [jnp.asarray(v) for v in vs]
                       for k, vs in sites.items()}, transform="dct",
                      avg_budget=4.5, compute_klt=True)
    tr = TC.calibrate({k: [_t(v) for v in vs] for k, vs in sites.items()},
                      transform="dct", avg_budget=4.5, compute_klt=True)
    assert tr.num_hi == jr.num_hi
    for k in sites:
        _eq(jr.klt_bases[k], tr.klt_bases[k])
        _eq(jr.act_absmax[k], tr.act_absmax[k])
        assert _rel(jr.energies[k], tr.energies[k]) <= RTOL
    with pytest.raises(ValueError):
        TC.calibrate({"empty": []})


def test_bitalloc():
    rng = np.random.default_rng(25)
    e = np.sort(rng.exponential(size=64).astype(np.float32) ** 3)[::-1]
    e[-1] = 0.0
    bits = JB.two_level_bits(64, 9)
    jopt, jbound = jax.jit(lambda v: (JB.optimal_bits(v, 4.25 * 64),
                                      JB.bound_value(v, bits, 32)))(
        jnp.asarray(e))
    # XLA's and PyTorch's f32 ``log`` part in the last bit now and then
    assert _rel(jopt, TB.optimal_bits(e, 4.25 * 64)) <= 2 ** -22
    for total in (4 * 64, 5 * 64 + 3, 2 * 64):
        _eq(JB.integer_rounded_allocation(e, total),
            TB.integer_rounded_allocation(e, total))
    _eq(bits, TB.two_level_bits(64, 9))
    _eq(jbound, TB.bound_value(e, TB.two_level_bits(64, 9), 32))
    assert TB.greedy_two_level(e, 4.25) == JB.greedy_two_level(e, 4.25)


def test_error_bounds():
    x = _acts(26)
    bits = np.where(np.arange(64) < 8, 8.0, 4.0).astype(np.float32)
    for b in (4, bits):
        tb = b if np.isscalar(b) else _t(b)

        def bounds(a, bb):
            return (JE.eq3_bound(a, bb), JE.theorem1_bound(a, bb),
                    JE.measured_error(a, bb))
        jr = jax.jit(bounds)(jnp.asarray(x), jnp.asarray(b))
        tr = (TE.eq3_bound(_t(x), tb), TE.theorem1_bound(_t(x), tb),
              TE.measured_error(_t(x), tb))
        for j, t in zip(jr, tr):
            assert _rel(j, t) <= 1e-6
    e = np.abs(x[0, :, 0]) ** 2
    for j, t in zip(JE.uniform_vs_concentrated(jnp.asarray(e), 4.125, 32),
                    TE.uniform_vs_concentrated(_t(e), 4.125, 32)):
        assert _rel(j, t) <= 1e-6


def test_capture_block_inputs():
    """The calibration taps of a reduced dense model carried over from the
    reference's weights: the embeddings bit-equal; the final hidden states
    (of unit scale: the final norm's gain is 1) each within two bf16 steps
    of the reference's and at least 99% of them bit-equal (at this input
    99.5% are, all but one of the rest one bf16 step apart and that one
    two: the bf16 products sum in other orders)."""
    dims = dict(name="taps-test", family="dense", num_layers=1, d_model=32,
                num_heads=2, num_kv_heads=1, d_ff=64, vocab_size=64)
    jcfg, tcfg = JModelConfig(**dims), TModelConfig(**dims)
    rng = np.random.default_rng(27)
    # the reference's parameter tree, filled from numpy (nothing compiled)
    jp = jax.tree.map(
        lambda a: jnp.asarray((rng.standard_normal(a.shape) * 0.1).astype(
            np.float32), a.dtype),
        jax.eval_shape(lambda k: JLM.init_params(k, jcfg),
                       jax.random.PRNGKey(1)))
    jp["final_norm"] = jnp.ones_like(jp["final_norm"])
    tp = TLM.from_jax_params(jax.tree.map(np.asarray, jp), tcfg)
    tokens = rng.integers(0, 64, (2, 16)).astype(np.int32)
    jt = JPTQ.capture_block_inputs(jp, {"tokens": jnp.asarray(tokens)}, jcfg)
    tt = TPTQ.capture_block_inputs(tp, {"tokens": _t(tokens)}, tcfg)
    assert len(tt) == len(jt) == 2
    _eq(jt[0], tt[0])
    assert np.abs(jt[1]).max() > 1.0
    np.testing.assert_allclose(tt[1], jt[1], rtol=2 ** -6, atol=0)
    assert (tt[1] == jt[1]).mean() >= 0.99

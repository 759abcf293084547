"""The reference's multimodal stacks against the port on the CPU:
llava-next-mistral-7b (its patch embeddings put before the prompt's
tokens), seamless-m4t-large-v2 (a non-causal encoder over frame
embeddings and cross-attention in every decoder layer) and pixart-sigma
(head_dim 72 at full width; its served path is held by
``test_torch_archs.py``), each at its reduced config.

Both sides run the reference's weights (``from_jax_params``) on the same
numpy-seeded batches: the reference with its Pallas kernels in interpret
mode, the port with its kernels' plain versions.  Tolerances:

* configs, the fused-site matrix, PTQ reports and packed weights, the
  quantizer codes of K1 at the patch span, and the refusals: exact;
* ``model_hidden`` (bf16, no quantizer): 5e-2 absolute, as
  ``test_torch_archs.py``, plus 5e-2 relative: a bf16 step grows with the
  value, and llava's patch rows (unit normal, 50 times the token
  embeddings' scale) carry the residual stream past 1 (measured: 0.055 at
  a value of 1.14, one element of 8192);
* the cross-attention block on the same input and encoder output: its
  ``xk`` / ``xv`` bit-equal in bf16 (and, under fused STaMP, every cache
  buffer), its output within ``LOGIT_TOL``;
* ``prefill`` and two ``decode_step`` s against ``jax.jit`` of the
  reference run in a process of its own without XLA's excess precision
  (in-process, its compiled chains keep bf16 values in f32: ROADMAP §3
  item 2), started with the module's first test: llava's logits
  within ``LOGIT_TOL = 0.1`` at both executions (measured: 0.066 and
  0.047), the decode steps (from the reference's cache) within
  ``LOGIT_TOL`` for both archs (measured: 0.023 at most).  Seamless's
  prefill under fused STaMP is the reference's bit for bit, its logits
  and every cache buffer, the encoder's output and so ``xk`` / ``xv``
  included (the encoder's linears take f32 sums rounded once, as the
  reference's compiled dots do; with the CPU's bf16 matmul its output
  differed in 6 of 3072 values).  Under reference execution seamless is
  held to ``XATTN_TOL = 0.25`` (measured: 0.145): the remainder of ROADMAP
  §3 item 2 passes through its cross-attention's per-token 4-bit
  quantize, which takes no transform (the paper's rule at pooled
  conditioning) and is not raised to 8 bits by the rows' setting;
* K4's and K6's plain versions at head_dim 72 against the Pallas kernels
  in interpret mode: ``RTOL = 1e-5`` relative, as ``test_torch_kernels.py``;
* the segment matmul (the twin of ``stamp_quant_segment_matmul_pallas``)
  against the Pallas kernel: 1e-5 relative.

The reference's decode step runs no cross-attention: its ``decode_step``
passes no encoder output to the stack, so the cached ``xk`` / ``xv`` are
written by the prefill and never read (zeroing them leaves its logits
bit-equal, measured).  The port does the same, and the decode tests hold
that the entries come through unchanged.
"""

import dataclasses
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
from repro.core import quant as JQ
from repro.core import transforms as JT
from repro.core.stamp import StampConfig as JStampConfig
from repro.core.stamp import prepare_linear as j_prepare_linear
from repro.data import pipeline as JDATA
from repro.kernels.cache_attention import (
    cache_decode_attention as j_cache_attention)
from repro.kernels.paged_attention import paged_ragged_attention as j_paged
from repro.kernels.stamp_matmul import (stamp_quant_matmul_pallas,
                                        stamp_quant_segment_matmul_pallas)
from repro.launch import serve as JSERVE
from repro.models import lm as JLM
from repro.serving import kvcache as JKV
from repro.serving import paged_kvcache as JPKV
from repro.serving.engine import PagedEngineConfig as JPagedConfig
from repro.serving.engine import PagedServingEngine as JPaged

from repro_torch import configs as TCONFIGS
from repro_torch.core import ptq as TPTQ
from repro_torch.core import stamp as TS
from repro_torch.core.stamp import StampConfig as TStampConfig
from repro_torch.kernels import ops as TO
from repro_torch.kernels import paged_attention as TPA
from repro_torch.kernels import stamp_matmul as TSM
from repro_torch.kernels.ref import cache_decode_attention_ref
from repro_torch.launch import serve as TSERVE
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.serving import kvcache as TKV
from repro_torch.serving import paged_kvcache as TPKV
from repro_torch.serving.engine import PagedEngineConfig as TPagedConfig
from repro_torch.serving.engine import PagedServingEngine as TPaged

from test_torch_archs import _shared_fields
from test_torch_cuda import paged_pools

LLAVA, SEAMLESS, PIXART = ("llava-next-mistral-7b", "seamless-m4t-large-v2",
                           "pixart-sigma")
ARCHS = (LLAVA, SEAMLESS)
EXECUTIONS = ("reference", "fused")
B, S, CAP, NUM_HI = 3, 32, 48, 8     # rows, prompt rows, cache, cache hi
LOGIT_TOL = 0.1
XATTN_TOL = 0.25
CACHE_MEAN_TOL = 0.02
RTOL = 1e-5
REFERENCE_TIMEOUT_S = 300


def _t(a) -> torch.Tensor:
    """A numpy (or JAX) array as a torch tensor; bf16 stays bf16."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(autouse=True)
def _reset_reference_switches():
    yield
    JLM.set_fused_cache_attention(False)
    JLM.set_fused_decode_matmul(False)


def _batch(cfg, b: int = B, s: int = S, seed: int = 0) -> dict:
    """A numpy batch as the reference's model tests make one: ``s`` rows of
    tokens, or ``num_patches`` patch embeddings and ``s - num_patches``
    tokens, plus ``s / frame_ratio`` frame embeddings for an encoder."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.frontend == "patch":
        out["tokens"] = out["tokens"][:, :s - cfg.num_patches]
        out["patches"] = rng.normal(
            size=(b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.encoder_layers:
        out["frames"] = rng.normal(
            size=(b, s // cfg.frame_ratio, cfg.d_model)).astype(np.float32)
    return out


def _jbatch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


_PARAMS: dict = {}


def _params(arch: str) -> tuple:
    """The reduced ``arch``'s reference weights (seed 0) and the port's
    copy of them."""
    if arch not in _PARAMS:
        jcfg = JCONFIGS.get_reduced(arch)
        jp = JLM.init_params(jax.random.PRNGKey(0), jcfg)
        tp = TLM.from_jax_params(jax.tree.map(np.asarray, jp),
                                 TCONFIGS.get_reduced(arch))
        _PARAMS[arch] = (jp, tp)
    return _PARAMS[arch]


def _serve_pair(execution: str):
    fused = execution == "fused"
    common = dict(cache_capacity=CAP, fused_cache_attention=fused,
                  fused_decode_matmul=fused)
    return (JLM.ServeConfig(stamp=JStampConfig(num_hi_tokens=S,
                                               execution=execution),
                            kv=JKV.KVCacheConfig(quantized=True,
                                                 num_hi=NUM_HI), **common),
            TLM.ServeConfig(stamp=TStampConfig(num_hi_tokens=S,
                                               execution=execution),
                            kv=TKV.KVCacheConfig(quantized=True,
                                                 num_hi=NUM_HI), **common))


# ---------------------------------------------------------------------------
# configs, weights, the calibration forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [LLAVA, SEAMLESS, PIXART])
def test_configs_equal_the_reference(arch):
    """``CONFIG`` and ``reduced()`` equal the reference's on every field,
    the frontend and encoder fields included, with the same layer plan;
    pixart-sigma's head_dim is 72 at full width."""
    pairs = [(JCONFIGS.get_config(arch), TCONFIGS.get_config(arch)),
             (JCONFIGS.get_reduced(arch), TCONFIGS.get_reduced(arch))]
    for j, t in pairs:
        fields = _shared_fields(j, t)
        assert {"encoder_layers", "frontend", "num_patches",
                "frame_ratio"} <= set(fields)
        assert set(fields) == {f.name for f in dataclasses.fields(j)}
        for name, (jv, tv) in fields.items():
            assert jv == tv, f"{arch}.{name}: {jv!r} != {tv!r}"
        for prop in ("padded_vocab", "resolved_head_dim", "q_dim", "kv_dim"):
            assert getattr(j, prop) == getattr(t, prop), prop
        jpro, jper, jn = j.layer_plan()
        assert t.layer_plan() == ((), (TLM.LayerSpec("attn", "mlp"),), jn)
        assert jpro == () and [(s.mixer, s.ffn) for s in jper] == \
            [("attn", "mlp")]
    assert TCONFIGS.canonical(arch) == JCONFIGS.canonical(arch)
    assert TCONFIGS.get_config(PIXART).resolved_head_dim == 72


def test_from_jax_params_carries_the_encoder_and_cross_attention():
    """The reference's ``encoder`` subtree (its stacked period) becomes the
    port's ``encoder`` layers and ``final_norm``, and each decoder layer
    keeps ``lnx`` and the ``xw*`` weights, value for value."""
    jp, tp = _params(SEAMLESS)
    cfg = TCONFIGS.get_reduced(SEAMLESS)
    enc = jp["encoder"]["period"][0]
    assert len(tp["encoder"]["layers"]) == cfg.encoder_layers
    for i, layer in enumerate(tp["encoder"]["layers"]):
        assert set(layer) == set(enc)
        assert not any(k.startswith("x") or k == "lnx" for k in layer)
        for k, v in enc.items():
            np.testing.assert_array_equal(layer[k].numpy(),
                                          np.asarray(v)[i], err_msg=k)
    np.testing.assert_array_equal(tp["encoder"]["final_norm"].numpy(),
                                  np.asarray(jp["encoder"]["final_norm"]))
    for i, layer in enumerate(tp["layers"]):
        for k in ("lnx", "xwq", "xwk", "xwv", "xwo"):
            np.testing.assert_array_equal(
                layer[k].numpy(), np.asarray(jp["period"][0][k])[i],
                err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_layout(arch):
    """The port's own seeded init has the reference's tree: the same
    leaves with the same shapes, encoder and cross-attention included."""
    jp, ref = _params(arch)
    cfg = TCONFIGS.get_reduced(arch)
    own = TLM.init_params(cfg, seed=1, device="cpu")

    def shapes(p):
        out = {k: tuple(v.shape) for k, v in p.items()
               if isinstance(v, torch.Tensor)}
        for i, layer in enumerate(p["layers"]):
            out.update({(i, k): tuple(v.shape) for k, v in layer.items()})
        if "encoder" in p:
            out["enc_norm"] = tuple(p["encoder"]["final_norm"].shape)
            for i, layer in enumerate(p["encoder"]["layers"]):
                out.update({("enc", i, k): tuple(v.shape)
                            for k, v in layer.items()})
        return out

    assert shapes(own) == shapes(ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_hidden_matches_reference(arch):
    """The calibration forward on a batch with patches or frames against
    the reference's ``model_hidden(mode="train")`` within 5e-2 absolute and
    5e-2 relative (module note); a bare token tensor raises the frontend's
    ``KeyError`` on both sides."""
    jp, tp = _params(arch)
    jcfg, tcfg = JCONFIGS.get_reduced(arch), TCONFIGS.get_reduced(arch)
    batch = _batch(jcfg, b=2)
    jx, _, _ = JLM.model_hidden(jp, _jbatch(batch), jcfg, mode="train",
                                policy=None, remat=False)
    tx = TLM.model_hidden(tp, _tbatch(batch), tcfg)
    assert tx.shape == (2, S, tcfg.d_model)
    np.testing.assert_allclose(tx.float().numpy(),
                               np.asarray(jx, np.float32), atol=5e-2,
                               rtol=5e-2)
    key = "patches" if arch == LLAVA else "frames"
    with pytest.raises(KeyError, match=key):
        JLM.model_hidden(jp, {"tokens": jnp.asarray(batch["tokens"])}, jcfg,
                         mode="train", policy=None, remat=False)
    with pytest.raises(KeyError, match=key):
        TLM.model_hidden(tp, torch.from_numpy(batch["tokens"]), tcfg)


def test_k1_codes_exact_at_the_patch_span():
    """K1's plain version at llava's first layer input (16 patch rows, then
    16 token rows, RMS-normed) against the reference's transform +
    mixed-precision quantize math compiled as its kernel is: codes, scales
    and zero points equal, at the DWT levels ``StampConfig`` resolves for
    the span."""
    jp, tp = _params(LLAVA)
    tcfg = TCONFIGS.get_reduced(LLAVA)
    x, _ = TLM.embed_inputs(tp, _tbatch(_batch(tcfg)), tcfg)
    h = TL.rms_norm(x, tp["layers"][0]["ln1"].to(x.dtype), tcfg.norm_eps)
    h = h.float().numpy()
    stamp = TStampConfig(num_hi_tokens=NUM_HI)
    levels = stamp.resolved_levels(S)
    assert levels == 2
    kw = dict(transform="dwt", levels=levels, skip_first=True,
              num_hi=NUM_HI, hi_bits=8, lo_bits=4)
    qx, sx, zx = TSM.transform_quantize_plain(torch.from_numpy(h), **kw)

    @jax.jit
    def reference(a):
        tx = JT.sequence_transform(a, "dwt", levels=levels, skip_first=True)
        bits = JQ.mixed_precision_bits(S, NUM_HI)
        s, z = JQ.minmax_scale_offset(tx, bits)
        return JQ.quantize(tx, s, z, bits), s, z

    q, s, z = reference(jnp.asarray(h))
    np.testing.assert_array_equal(
        qx.numpy(), np.asarray(q - 128.0).astype(np.int8).reshape(
            -1, tcfg.d_model))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(s).reshape(-1))
    np.testing.assert_array_equal(zx.numpy(),
                                  np.asarray(z - 128.0).reshape(-1))


# ---------------------------------------------------------------------------
# the cross-attention block, the site matrix, the cache layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("execution", EXECUTIONS)
def test_cross_attention_block_matches_reference(execution):
    """Seamless's first decoder layer in prefill mode (self-attention, the
    cache, then cross-attention to the encoder output) against ``jax.jit``
    of the reference's ``attn_block`` on the same input and encoder output:
    the cross-attention's ``xk`` / ``xv`` bit-equal in bf16, under fused
    STaMP every cache buffer too, the output within ``LOGIT_TOL``."""
    jp, tp = _params(SEAMLESS)
    jcfg, tcfg = JCONFIGS.get_reduced(SEAMLESS), TCONFIGS.get_reduced(
        SEAMLESS)
    jserve, tserve = _serve_pair(execution)
    if execution == "fused":
        jp = JLM.prepare_fused_weights(jp, jserve.stamp)
        tp = TLM.prepare_fused_weights(tp, tserve.stamp)
    batch = _batch(jcfg)
    enc = jax.jit(lambda p, f: JLM._encoder_forward(
        p, f.astype(jnp.bfloat16), jcfg, None, "prefill"))(
        jp, jnp.asarray(batch["frames"]))
    x = JLM._embed(jp, jnp.asarray(batch["tokens"]))
    p0 = jax.tree.map(lambda a: a[0], jp["period"][0])
    jx, jentry = jax.jit(lambda p, a, e: JLM.attn_block(
        p, a, jcfg, mode="prefill", positions=jnp.arange(S)[None, :],
        policy=None, stamp=jserve.stamp, kv_cfg=jserve.kv, enc_out=e,
        cache_capacity=CAP))(p0, x, enc)
    tx, tentry = TLM.attn_block_prefill(tp["layers"][0], _t(x), tcfg,
                                        tserve.stamp, tserve.kv, CAP,
                                        _t(enc))
    assert set(tentry) == set(jentry)
    for k in ("xk", "xv"):
        assert tentry[k].dtype == torch.bfloat16
        assert torch.equal(tentry[k], _t(jentry[k])), k
    if execution == "fused":
        for k in jentry:
            assert torch.equal(tentry[k], _t(jentry[k])), k
    np.testing.assert_allclose(tx.float().numpy(),
                               np.asarray(jx, np.float32), atol=LOGIT_TOL)


@pytest.mark.parametrize("arch", [LLAVA, SEAMLESS, PIXART])
@pytest.mark.parametrize("stamp", ["none", "fused", "klt"])
def test_fused_site_matrix_matches_reference(arch, stamp):
    """The per-site audit equals the reference's: the decoder sites as the
    dense archs', and for seamless ``cross_attn`` (every decoder layer,
    ``site_cross_attn_no_seq_transform``) and ``encoder`` (every encoder
    layer, ``site_encoder_unstamped``) in reference execution whatever the
    config says."""
    cfgs = {"none": (None, None),
            "fused": (JStampConfig(execution="fused"),
                      TStampConfig(execution="fused")),
            "klt": (JStampConfig(execution="fused", seq_transform="klt"),
                    TStampConfig(execution="fused", seq_transform="klt"))}
    js, ts = cfgs[stamp]
    jm = JLM.fused_site_matrix(JCONFIGS.get_config(arch), js)
    tm = TLM.fused_site_matrix(TCONFIGS.get_config(arch), ts)
    assert tm == jm
    if arch == SEAMLESS:
        assert tm["cross_attn"]["layers"] == 24
        assert tm["encoder"]["reasons"] == ["site_encoder_unstamped"]


def test_init_cache_matches_reference():
    """Seamless's zero contiguous cache: every layer's entry has the
    reference's buffers, shapes and dtypes, the bf16 ``xk`` / ``xv`` of
    ``seq // frame_ratio`` positions included."""
    jcfg, tcfg = JCONFIGS.get_reduced(SEAMLESS), TCONFIGS.get_reduced(
        SEAMLESS)
    jserve, tserve = _serve_pair("fused")
    jc = JLM.init_cache(jcfg, 2, 40, jserve)
    tc = TLM.init_cache(tcfg, 2, 40, tserve, device="cpu")
    assert len(tc) == tcfg.num_layers
    for entry in tc:
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in entry.items()} == \
            {k: (tuple(v.shape[1:]), str(v.dtype))
             for k, v in jc["0"].items()}
    assert tc[0]["xk"].shape == (2, 10, 4, 32)


# ---------------------------------------------------------------------------
# PTQ, and what the reference refuses
# ---------------------------------------------------------------------------


def test_prefill_takes_a_precomputed_encoder_output():
    """``prefill`` given ``enc_out`` (the encoder's output for the batch's
    frames) runs no encoder and gives the logits and every cache buffer of
    the prefill that runs it, bit for bit."""
    tp, tcfg, tserve = _port_prefill(SEAMLESS, "fused")
    batch = _tbatch(_batch(tcfg))
    enc = TLM.encoder_forward(tp, batch["frames"], tcfg)
    want_l, want_c = TLM.prefill(tp, batch, tcfg, tserve)
    got_l, got_c = TLM.prefill(tp, dict(batch, frames=batch["frames"] * 0),
                               tcfg, tserve, enc_out=enc)
    assert torch.equal(got_l, want_l)
    for got, want in zip(got_c, want_c):
        assert all(torch.equal(got[k], want[k]) for k in want)


def _calibration(cfg, with_frontend: bool) -> list:
    """The serve CLI's calibration batches (2 × 2 × 64 tokens), with the
    frontend's inputs added where asked."""
    batches = JDATA.calibration_batches(
        JDATA.DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                         global_batch=2), 2)
    if not with_frontend:
        return batches
    rng = np.random.default_rng(7)
    for b in batches:
        n = b["tokens"].shape[0]
        if cfg.encoder_layers:
            b["frames"] = rng.normal(size=(n, 64 // cfg.frame_ratio,
                                           cfg.d_model)).astype(np.float32)
        if cfg.frontend == "patch":
            b["patches"] = rng.normal(size=(n, cfg.num_patches,
                                            cfg.d_model)).astype(np.float32)
    return batches


def test_ptq_with_frames_matches_reference():
    """Seamless calibrates on batches with frames: the same ``num_hi``,
    ``avg_bits`` and Toeplitz fraction, and bit-identical packed int4
    weights at every linear site of the decoder (``xw*`` included) and of
    the encoder."""
    jp, tp = _params(SEAMLESS)
    jcfg, tcfg = JCONFIGS.get_reduced(SEAMLESS), TCONFIGS.get_reduced(
        SEAMLESS)
    batches = _calibration(jcfg, True)
    jsp, jserve, jrep = JPTQ.calibrate_and_quantize(jp, batches, jcfg)
    tsp, tserve, trep = TPTQ.calibrate_and_quantize(tp, batches, tcfg,
                                                    device="cpu")
    assert (trep.num_hi, trep.avg_bits) == (jrep.num_hi, jrep.avg_bits)
    assert abs(trep.toeplitz_fraction - jrep.toeplitz_fraction) < 1e-2
    assert tserve.kv.num_hi == jserve.kv.num_hi
    sites = {"layers": (jsp["period"][0], ("wq", "wk", "wv", "wo", "xwq",
                                           "xwk", "xwv", "xwo", "wi_gate",
                                           "wi_up", "wo_mlp")),
             "encoder": (jsp["encoder"]["period"][0],
                         ("wq", "wk", "wv", "wo", "wi_gate", "wi_up",
                          "wo_mlp"))}
    for where, (jtree, names) in sites.items():
        layers = tsp["layers"] if where == "layers" else \
            tsp["encoder"]["layers"]
        for name in names:
            for i, layer in enumerate(layers):
                for part in ("q", "scale", "zp"):
                    np.testing.assert_array_equal(
                        layer[name][part].numpy(),
                        np.asarray(jtree[name][part])[i],
                        err_msg=f"{where}.{name}.{part}")
        assert layers[0]["ln1"].dtype == torch.bfloat16
    assert tsp["encoder"]["final_norm"].dtype == torch.bfloat16


def test_ptq_raises_on_the_patch_batch_as_the_reference():
    """The reference taps the text-only embedding beside the patch-long
    hidden state, and its statistics fail to broadcast; the port copies
    that, with the same message."""
    jp, tp = _params(LLAVA)
    jcfg, tcfg = JCONFIGS.get_reduced(LLAVA), TCONFIGS.get_reduced(LLAVA)
    batches = _calibration(jcfg, True)
    with pytest.raises(ValueError) as jerr:
        JPTQ.calibrate_and_quantize(jp, batches, jcfg)
    with pytest.raises(ValueError) as terr:
        TPTQ.calibrate_and_quantize(tp, batches, tcfg, device="cpu")
    assert "could not be broadcast" in str(terr.value)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("arch", ARCHS)
def test_token_only_calibration_raises_keyerror(arch, monkeypatch):
    """Calibration batches of tokens alone (the serve CLI's) raise the
    frontend's ``KeyError`` in both PTQs, and so the serve CLIs end there
    for llava (``patches``) and for seamless with ``--engine bucketed``
    (``frames``)."""
    jp, tp = _params(arch)
    jcfg, tcfg = JCONFIGS.get_reduced(arch), TCONFIGS.get_reduced(arch)
    key = "patches" if arch == LLAVA else "frames"
    batches = _calibration(jcfg, False)
    with pytest.raises(KeyError, match=key):
        JPTQ.calibrate_and_quantize(jp, batches, jcfg)
    with pytest.raises(KeyError, match=key):
        TPTQ.calibrate_and_quantize(tp, batches, tcfg, device="cpu")
    argv = ["--arch", arch, "--reduced", "--engine", "bucketed",
            "--requests", "1"]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    with pytest.raises(KeyError, match=key):
        JSERVE.main()
    with pytest.raises(KeyError, match=key):
        TSERVE.build(TSERVE.parse_args([*argv, "--device", "cpu"]))


def test_paged_serving_refuses_encoder_decoder(monkeypatch, capsys):
    """Both sides refuse an enc-dec stack in paged serving: the cache init
    and the paged engine raise ``NotImplementedError`` naming
    ``BucketedEngine`` (the port's engine before it prepares or allocates
    anything: it is handed no weights at all), and the serve CLI's
    ``--engine paged`` is an argument error naming ``--engine bucketed``."""
    jp, _ = _params(SEAMLESS)
    jcfg, tcfg = JCONFIGS.get_reduced(SEAMLESS), TCONFIGS.get_reduced(
        SEAMLESS)
    jserve, tserve = _serve_pair("fused")
    jpcfg = JPKV.PagedCacheConfig(block_size=8, num_lo_blocks=9,
                                  num_hi_blocks=3, max_blocks_per_seq=4,
                                  quant=jserve.kv)
    tpcfg = TPKV.PagedCacheConfig(block_size=8, num_lo_blocks=9,
                                  num_hi_blocks=3, max_blocks_per_seq=4,
                                  quant=tserve.kv)
    with pytest.raises(NotImplementedError, match="BucketedEngine"):
        JLM.init_paged_cache(jcfg, jpcfg)
    with pytest.raises(NotImplementedError, match="BucketedEngine"):
        TLM.init_paged_cache(tcfg, tpcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="BucketedEngine"):
        JPaged(jp, jcfg, jserve, JPagedConfig(block_size=NUM_HI))
    with pytest.raises(NotImplementedError, match="BucketedEngine"):
        TPaged({}, tcfg, tserve, TPagedConfig(), device="cpu")
    argv = ["--arch", SEAMLESS, "--reduced"]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    with pytest.raises(SystemExit) as jexit:
        JSERVE.main()
    jmsg = capsys.readouterr().err
    with pytest.raises(SystemExit) as texit:
        TSERVE.parse_args([*argv, "--device", "cpu"])
    tmsg = capsys.readouterr().err
    assert jexit.value.code == texit.value.code == 2
    for msg in (jmsg, tmsg):
        assert "encoder-decoder" in msg and "--engine bucketed" in msg
    # the bucketed engine's arguments, and a decoder-only arch, parse
    assert TSERVE.parse_args([*argv, "--engine", "bucketed"]).engine == \
        "bucketed"
    assert TSERVE.parse_args(["--arch", PIXART, "--reduced"]).engine == \
        "paged"


# ---------------------------------------------------------------------------
# the kernels at head_dim 72, and the segment matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block_size", [4, 16])
def test_paged_attention_plain_matches_pallas_at_head_dim_72(block_size):
    """K4's plain version at head_dim 72, one query head a kv head (PixArt
    at full width), mixed prefill and decode spans, against the reference's
    ``paged_ragged_attention`` in interpret mode."""
    spans = [(16, 27), (0, 9), (29, 30), (8, 9)]
    entry, ht, lt = paged_pools(block_size, 16, spans, g=2, hd=72,
                                seed=block_size)
    jentry = {name: jnp.asarray(a.numpy()) for name, a in entry.items()}
    rng = np.random.default_rng(block_size + 1)
    q_pf = rng.standard_normal((2, 12, 2, 72)).astype(np.float32)
    q_dec = rng.standard_normal((2, 1, 2, 72)).astype(np.float32)
    starts = np.array([s for s, _ in spans], np.int32)
    lengths = np.array([n for _, n in spans], np.int32)
    j_pf, j_dec = j_paged(jentry, jnp.asarray(q_pf), jnp.asarray(q_dec),
                          jnp.asarray(starts), jnp.asarray(lengths),
                          jnp.asarray(ht), jnp.asarray(lt), block_size,
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


def test_cache_attention_plain_matches_pallas_at_head_dim_72():
    """K6's plain version at head_dim 72 (PixArt's 16 heads of 72 over 16
    kv heads) against the reference's ``cache_decode_attention`` in
    interpret mode, ragged per-slot lengths inside the hi region and
    across lo blocks; the wrapper on CPU tensors is that plain version and
    counts no launch."""
    b, s, g, hd, h, num_hi, bs = 3, 168, 4, 72, 4, 8, 32
    rng = np.random.default_rng(72)
    k = rng.standard_normal((b, s, g, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, g, hd)).astype(np.float32)
    q = rng.standard_normal((b, 1, h, hd)).astype(np.float32)
    jcfg = JKV.KVCacheConfig(quantized=True, num_hi=num_hi)
    jent = jax.jit(lambda a, c: JKV.quantize_full(a, c, jcfg))(
        jnp.asarray(k), jnp.asarray(v))
    tent = TKV.quantize_full(_t(k), _t(v),
                             TKV.KVCacheConfig(quantized=True, num_hi=num_hi))
    length = np.asarray((5, 30, 168), np.int32)
    want = j_cache_attention(jent, jnp.asarray(q), jnp.asarray(length),
                             block_s=bs, interpret=True)
    got = cache_decode_attention_ref(tent, _t(q), _t(length), block_s=bs)
    assert _rel(got.numpy(), want) <= RTOL
    TO.reset_launch_counts()
    np.testing.assert_array_equal(
        TO.cache_decode_attention(tent, _t(q), _t(length)).numpy(),
        cache_decode_attention_ref(tent, _t(q), _t(length)).numpy())
    assert TO.launch_counts()["cache_decode_attention"] == 0


def test_segment_matmul_matches_pallas():
    """``stamp_quant_segment_matmul`` (K1 → K2's plain versions over spans
    folded onto the batch) against ``stamp_quant_segment_matmul_pallas``
    and one reference kernel call per span, within 1e-5; a length that is
    not whole segments raises the reference's ``ValueError`` on both
    sides (the reference's own test, ``tests/test_unified_step.py``)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 24, 16)).astype(np.float32)
    w = rng.normal(size=(16, 32)).astype(np.float32)
    jprep = j_prepare_linear(jnp.asarray(w))
    tprep = TS.prepare_linear(_t(w))
    bias = np.zeros((1, 32), np.float32)
    kw = dict(transform="dwt", levels=1, num_hi=4)
    want = stamp_quant_segment_matmul_pallas(
        jnp.asarray(x), jprep.qw, jprep.sw, jprep.zw, jnp.asarray(bias),
        seg_len=8, interpret=True, **kw)
    per_span = jnp.concatenate(
        [stamp_quant_matmul_pallas(jnp.asarray(x[:, i:i + 8]), jprep.qw,
                                   jprep.sw, jprep.zw, jnp.asarray(bias),
                                   interpret=True, **kw)
         for i in range(0, 24, 8)], axis=1)
    TO.reset_launch_counts()
    got = TO.stamp_quant_segment_matmul(
        _t(x), tprep.qw, tprep.sw, tprep.zw, tprep.qw_sum, _t(bias),
        seg_len=8, **kw)
    assert got.shape == (2, 24, 32)
    assert _rel(got.numpy(), want) <= RTOL
    assert _rel(got.numpy(), per_span) <= RTOL
    assert sum(TO.launch_counts().values()) == 0
    with pytest.raises(ValueError, match="whole number"):
        stamp_quant_segment_matmul_pallas(
            jnp.asarray(x), jprep.qw, jprep.sw, jprep.zw, jnp.asarray(bias),
            seg_len=7, interpret=True, **kw)
    with pytest.raises(ValueError, match="whole number"):
        TO.stamp_quant_segment_matmul(_t(x), tprep.qw, tprep.sw, tprep.zw,
                                      tprep.qw_sum, seg_len=7, **kw)


# ---------------------------------------------------------------------------
# prefill and decode_step against the reference without excess precision
# ---------------------------------------------------------------------------

# The reference's prefill and decode steps on the reduced llava and
# seamless (weights and batches from the pickle ``argv[1] + ".in"``), run in
# a process of its own so that XLA_FLAGS reaches the backend before it
# starts.
_REFERENCE_STEPS = """
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

path = sys.argv[1]
with open(path + ".in", "rb") as f:
    cases, s, cap, num_hi = pickle.load(f)


def serve_for(execution):
    fused = execution == "fused"
    return JLM.ServeConfig(
        stamp=StampConfig(num_hi_tokens=s, execution=execution),
        kv=JKV.KVCacheConfig(quantized=True, num_hi=num_hi),
        cache_capacity=cap, fused_cache_attention=fused,
        fused_decode_matmul=fused)


def host(tree):
    return jax.tree.map(np.asarray, tree)


out = {}
for arch, (params, batch) in cases.items():
    cfg = configs.get_reduced(arch)
    params = jax.tree.map(jnp.asarray, params)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    for execution in ("reference", "fused"):
        serve = serve_for(execution)
        p = params
        if execution == "fused":
            p = JLM.prepare_fused_weights(params, serve.stamp)
        logits, cache = jax.jit(
            lambda p, b: JLM.prefill(p, b, cfg, serve))(p, batch)
        step = jax.jit(lambda p, c, t, pos: JLM.decode_step(
            p, c, t, pos, cfg, serve))
        tok = np.asarray(logits).argmax(-1).astype(np.int32)
        decode = []
        c = cache
        for n in range(2):
            pos = np.full(tok.shape, s + n, np.int32)
            dl, c = step(p, c, jnp.asarray(tok), jnp.asarray(pos))
            decode.append((tok, pos, np.asarray(dl)))
            tok = np.asarray(dl).argmax(-1).astype(np.int32)
        out[arch, execution] = dict(prefill=np.asarray(logits),
                                    cache=host(cache), decode=decode,
                                    cache_after=host(c))
with open(path + ".out", "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module", autouse=True)
def reference_process(tmp_path_factory):
    """The reference's steps in a process of its own without XLA's excess
    precision, started with the module's first test so that it runs beside
    the tests above; :func:`reference_steps` reads its output."""
    path = str(tmp_path_factory.mktemp("multimodal") / "steps")
    cases = {arch: (jax.tree.map(np.asarray, _params(arch)[0]),
                    _batch(JCONFIGS.get_reduced(arch))) for arch in ARCHS}
    with open(path + ".in", "wb") as f:
        pickle.dump((cases, S, CAP, NUM_HI), f)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_allow_excess_precision=false").strip()
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE_STEPS, path],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    yield proc, path
    proc.kill()


@pytest.fixture(scope="module")
def reference_steps(reference_process):
    """What the reference's process wrote, once it has ended."""
    proc, path = reference_process
    log = proc.communicate(timeout=REFERENCE_TIMEOUT_S)[0]
    assert proc.returncode == 0, log[-3000:]
    with open(path + ".out", "rb") as f:
        return pickle.load(f)


def _port_prefill(arch: str, execution: str):
    _, tp = _params(arch)
    tcfg = TCONFIGS.get_reduced(arch)
    _, tserve = _serve_pair(execution)
    if execution == "fused":
        tp = TLM.prepare_fused_weights(tp, tserve.stamp)
    return tp, tcfg, tserve


def _assert_cache_like(tcache: list, jcache: dict, kv) -> None:
    """The reference's layout (buffers, shapes, dtypes) per layer, and the
    dequantized K/V within ``CACHE_MEAN_TOL`` on average."""
    for i, entry in enumerate(tcache):
        ref = {k: _t(np.asarray(v)[i]) for k, v in jcache["0"].items()}
        assert {k: (v.shape, v.dtype) for k, v in entry.items()} == \
            {k: (v.shape, v.dtype) for k, v in ref.items()}
        for a, b in zip(TKV.dequantize_full(entry, kv, torch.float32),
                        TKV.dequantize_full(ref, kv, torch.float32)):
            assert float((a - b).abs().mean()) <= CACHE_MEAN_TOL, i


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("execution", EXECUTIONS)
def test_prefill_matches_reference(reference_steps, arch, execution):
    """``prefill`` on the batch dict: llava's logits (patch rows first,
    the last token's logits) within ``LOGIT_TOL``; seamless's, under fused
    STaMP, bit-equal with every cache buffer (``xk`` / ``xv`` included),
    under reference execution within ``XATTN_TOL`` with ``xk`` / ``xv``
    bit-equal (module note); the caches' layouts and dequantized K/V
    within ``CACHE_MEAN_TOL`` on average."""
    ref = reference_steps[arch, execution]
    tp, tcfg, tserve = _port_prefill(arch, execution)
    tl, tc = TLM.prefill(tp, _tbatch(_batch(tcfg)), tcfg, tserve)
    assert tl.shape == ref["prefill"].shape == (B, tcfg.padded_vocab)
    _assert_cache_like(tc, ref["cache"], tserve.kv)
    if arch == LLAVA:
        assert float(np.abs(tl.numpy() - ref["prefill"]).max()) <= LOGIT_TOL
        return
    exact = ref["cache"]["0"] if execution == "fused" else ("xk", "xv")
    for i, entry in enumerate(tc):
        for k in exact:
            assert torch.equal(entry[k],
                               _t(np.asarray(ref["cache"]["0"][k])[i])), \
                (i, k)
    if execution == "fused":
        np.testing.assert_array_equal(tl.numpy(), ref["prefill"])
    else:
        assert float(np.abs(tl.numpy() - ref["prefill"]).max()) <= \
            XATTN_TOL


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("execution", EXECUTIONS)
def test_decode_steps_match_reference(reference_steps, arch, execution):
    """Two ``decode_step`` s at per-slot positions from the reference's
    prefill cache (the port's copy of it), the reference's tokens fed:
    logits within ``LOGIT_TOL`` — fused (K6's and K3's plain versions) and
    plain (measured: equal but for 0.023 on one llava step).  The first layer's cache after the steps is the reference's,
    bit for bit, ``xk`` / ``xv`` carried unchanged (no cross-attention at
    decode, on either side)."""
    ref = reference_steps[arch, execution]
    tp, tcfg, tserve = _port_prefill(arch, execution)
    jcache = ref["cache"]
    tcache = [{k: _t(np.asarray(v)[i]) for k, v in jcache["0"].items()}
              for i in range(tcfg.num_layers)]
    for tok, pos, want in ref["decode"]:
        tl, tcache = TLM.decode_step(tp, tcache, _t(tok), _t(pos), tcfg,
                                     tserve)
        assert float(np.abs(tl.numpy() - want).max()) <= LOGIT_TOL
    after = {k: _t(np.asarray(v)[0]) for k, v in ref["cache_after"]["0"]
             .items()}
    if execution == "fused":
        for k in after:
            assert torch.equal(tcache[0][k], after[k]), k
    for k in (("xk", "xv") if arch == SEAMLESS else ()):
        assert torch.equal(tcache[0][k], _t(np.asarray(jcache["0"][k])[0]))

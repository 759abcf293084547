"""Dense GQA, MoE, hybrid (Jamba) and pure-SSM (Mamba2) decoders, and the
multimodal stacks (LLaVA's patch frontend, Seamless's encoder and
cross-attention): calibration forward, the paged serving
steps (the unified step; the two-call pair ``paged_prefill_chunk`` /
``paged_decode_step``), and the contiguous-cache ``prefill`` /
``decode_step`` of the bucketed engine, and the training loss
(``train_loss``: the full-sequence forward with each layer recomputed in
the backward, then ``chunked_xent``) — the port of those paths of
``repro.models.lm``.  With ``ServeConfig.quant_telemetry`` the prefill
entry points also return the per-site quant-health stats
(`repro_torch.obs.quantstats`); ``fused_site_matrix`` is the per-site
fused / reference audit the engines publish.

Parameters are a plain dict of tensors: ``embed``, ``final_norm``,
``head`` (absent when tied) and ``layers`` — one dict per layer (the
reference's prologue and scanned ``period`` stack unrolled; each layer's
``LayerSpec`` comes from ``cfg.layer_specs()``).  Stored f32 or bf16 and
cast to bf16 at use; serving params hold packed-int4 or prepared-int8 dicts
for the large matmuls.  Mamba layers hold ``in_proj`` / ``out_proj``,
``conv_w``, ``a_log``, ``dt_bias``, ``d_skip`` and ``ssm_norm``; their
cache entry is the recurrent state (``{"state", "conv"}``, slot-dense in
the paged pools).  An encoder-decoder stack's decoder attention layers
also hold the cross-attention ``lnx`` / ``xwq`` / ``xwk`` / ``xwv`` /
``xwo`` (their contiguous cache entry adds the encoder output's bf16
``xk`` / ``xv``), and ``params["encoder"]`` holds the encoder's
``layers`` (attention + MLP, no cross-attention) and ``final_norm``.  The
multimodal entry points (``model_hidden``, ``prefill``) take a batch dict
as the reference's do — ``tokens`` plus ``patches`` (b, num_patches, d)
or ``frames`` (b, s_enc, d) — and a bare tensor as tokens.  MoE layers
hold the router ``gate_w`` and the
stacked ``(E, ·, ·)`` expert weights ``we_gate / we_up / we_down``; Arctic's
dense residual MLP is ``dwi_gate / dwi_up / dwo_mlp``.  Setup at full width
streams: expert stacks are drawn, packed and prepared one expert at a time,
and ``init_params(lazy=True)`` draws each layer only when it is reached.

Kernel routing is explicit: the serve config carries
``fused_cache_attention`` and ``fused_decode_matmul`` into every step, and
a linear takes the decode kernel only for decode-shaped ``(S, 1, d)`` input
over prepared weights — chunk rows never do, so prefill always runs the
STaMP transform.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.stamp import (StampConfig, fused_eligible,
                                    fused_ineligibility, prepare_linear,
                                    stamp_fake_quant)
from repro_torch.core.quant import EPS, fake_quant, fdiv
from repro_torch.device import fake_mode_active, resolve_device
from repro_torch.kernels.cache_attention import (NEVER,
                                                 cache_decode_attention,
                                                 merge_states)
from repro_torch.kernels.decode_matmul import (decode_row_minmax,
                                               stamp_decode_matmul,
                                               stamp_decode_matmul_parts,
                                               stamp_decode_matmul_summed)
from repro_torch.kernels.paged_attention import (paged_decode_attention,
                                                 paged_ragged_attention)
from repro_torch.kernels.ref import merge_states_ref
from repro_torch.kernels.stamp_matmul import down_slab_sums, silu
from repro_torch.models import layers as L
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.obs import quantstats as QS
from repro_torch.serving import kvcache as KV
from repro_torch.serving import paged_kvcache as PKV
from repro_torch.sharding import (ModelSplit, SeqGroup, ShardingPolicy,
                                  constrain)

COMPUTE_DTYPE = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Inference-time quantization (the paper's W4A4KV4) and the kernel
    routing of the serving steps."""

    stamp: Optional[StampConfig] = None          # activation STaMP (prefill)
    kv: KV.KVCacheConfig = KV.KVCacheConfig()
    weight_bits: Optional[int] = None            # 4 => packed-int4 weights
    cache_capacity: Optional[int] = None         # contiguous cache length
    fused_cache_attention: bool = False          # packed-cache attention
    fused_decode_matmul: bool = False            # single-token int8 kernel
    paged: Optional[PKV.PagedCacheConfig] = None
    # the serving engines check each step's logits for NaN / Inf and
    # quarantine the request (engine.py)
    numerics_guard: bool = False
    # per-STaMP-site quant-health stats (obs/quantstats.py) returned beside
    # the step outputs; changes the arity of prefill / paged_prefill_chunk
    # / paged_unified_step's returns
    quant_telemetry: bool = False


def _collect_telemetry(serve: ServeConfig) -> bool:
    """Whether the entry points collect quant telemetry: only when a STaMP
    config is quantizing, so default configs keep their return arities."""
    return (serve.quant_telemetry and serve.stamp is not None
            and serve.stamp.enabled)


def _with_telemetry(collect: bool, fn):
    """Run ``fn()`` inside a telemetry scope when ``collect``; returns
    ``(out, stats or None)``."""
    if not collect:
        return fn(), None
    QS.begin()
    try:
        out = fn()
    finally:
        stats = QS.end()
    return out, stats


# ---------------------------------------------------------------------------
# init and weight conversion
# ---------------------------------------------------------------------------


def _dense(gen, din, dout, device, dtype, std=None):
    std = std if std is not None else 1.0 / np.sqrt(din)
    return (torch.randn((din, dout), generator=gen, device=device)
            * std).to(dtype)


def _expert_stack(gen, e, din, dout, device, dtype):
    """(E, din, dout) drawn one expert at a time in f32 and stored in
    ``dtype``: no f32 stack is ever held (one Arctic stack is 17.8 GB in
    f32), and a bf16 stack equals the f32 one cast.  Under a
    ``FakeTensorMode`` nothing is drawn (the stack's shape is all)."""
    out = torch.empty((e, din, dout), dtype=dtype, device=device)
    if fake_mode_active():
        return out
    for i in range(e):
        out[i] = _dense(gen, din, dout, device, dtype)
    return out


def _init_layer(cfg: ModelConfig, spec: LayerSpec, gen, dev, dtype) -> dict:
    d = cfg.d_model

    def ones(n):
        return torch.ones(n, device=dev, dtype=dtype)

    p = {"ln1": ones(d)}
    if spec.mixer == "attn":
        p["wq"] = _dense(gen, d, cfg.q_dim, dev, dtype)
        p["wk"] = _dense(gen, d, cfg.kv_dim, dev, dtype)
        p["wv"] = _dense(gen, d, cfg.kv_dim, dev, dtype)
        p["wo"] = _dense(gen, cfg.q_dim, d, dev, dtype)
        if cfg.qkv_bias:
            p["bq"] = torch.zeros(cfg.q_dim, device=dev, dtype=dtype)
            p["bk"] = torch.zeros(cfg.kv_dim, device=dev, dtype=dtype)
            p["bv"] = torch.zeros(cfg.kv_dim, device=dev, dtype=dtype)
        if cfg.encoder_layers:       # decoder layers carry cross-attention
            p["lnx"] = ones(d)
            p["xwq"] = _dense(gen, d, cfg.q_dim, dev, dtype)
            p["xwk"] = _dense(gen, d, cfg.kv_dim, dev, dtype)
            p["xwv"] = _dense(gen, d, cfg.kv_dim, dev, dtype)
            p["xwo"] = _dense(gen, cfg.q_dim, d, dev, dtype)
    elif spec.mixer == "mamba":
        di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        f32 = dict(device=dev, dtype=torch.float32)
        p["in_proj"] = _dense(gen, d, 2 * di + 2 * n + h, dev, dtype)
        p["conv_w"] = (torch.randn((cfg.conv_width, di + 2 * n),
                                   generator=gen, device=dev)
                       * 0.1).to(dtype)
        # the SSM's per-head parameters stay f32, as the reference's
        p["a_log"] = torch.zeros(h, **f32)
        p["dt_bias"] = torch.full((h,), -2.0, **f32)
        p["d_skip"] = torch.ones(h, **f32)
        p["ssm_norm"] = ones(di)
        p["out_proj"] = _dense(gen, di, d, dev, dtype)
    if spec.ffn != "none":
        p["ln2"] = ones(d)
    if spec.ffn in ("mlp", "moe_dense"):
        pre = "d" if spec.ffn == "moe_dense" else ""
        p[f"{pre}wi_gate"] = _dense(gen, d, cfg.d_ff, dev, dtype)
        p[f"{pre}wi_up"] = _dense(gen, d, cfg.d_ff, dev, dtype)
        p[f"{pre}wo_mlp"] = _dense(gen, cfg.d_ff, d, dev, dtype)
    if spec.ffn in ("moe", "moe_dense"):
        e, f = cfg.num_experts, cfg.expert_d_ff
        # stored in ``dtype`` as the reference's; routing upcasts it to f32
        p["gate_w"] = _dense(gen, d, e, dev, dtype)
        p["we_gate"] = _expert_stack(gen, e, d, f, dev, dtype)
        p["we_up"] = _expert_stack(gen, e, d, f, dev, dtype)
        p["we_down"] = _expert_stack(gen, e, f, d, dev, dtype)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                dtype=torch.float32, lazy: bool = False) -> dict:
    """Random parameters from ``seed`` (a ``torch.Generator`` on the
    target device), with the reference's shapes and scales, drawn in f32
    and stored in ``dtype`` (a bf16 model equals the f32 one cast, MoE
    routers included, as the reference's).  An encoder-decoder stack's
    ``encoder`` (its layers without cross-attention, and its
    ``final_norm``) is drawn before the decoder layers.  With
    ``lazy``, ``layers`` is an iterator that draws each layer when it is
    reached, with the same numbers: a full-width MoE stack is set up one
    layer at a time.  Runs on ``cuda`` unless ``device`` says otherwise.
    Under a ``FakeTensorMode`` (the dry run's stand-ins) nothing is drawn:
    the leaves are shapes, and no generator is made."""
    dev = resolve_device(device)
    specs = cfg.layer_specs()
    gen = None
    if not fake_mode_active():
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    d = cfg.d_model
    params = {
        "embed": (torch.randn((cfg.padded_vocab, d), generator=gen,
                              device=dev) * 0.02).to(dtype),
        "final_norm": torch.ones(d, device=dev, dtype=dtype),
    }
    if not cfg.tie_embeddings:
        params["head"] = _dense(gen, d, cfg.padded_vocab, dev, dtype)
    if cfg.encoder_layers:
        enc_cfg = dataclasses.replace(cfg, encoder_layers=0)
        params["encoder"] = {
            "layers": [_init_layer(enc_cfg, _ENCODER_SPEC, gen, dev, dtype)
                       for _ in range(cfg.encoder_layers)],
            "final_norm": torch.ones(d, device=dev, dtype=dtype)}
    layers = (_init_layer(cfg, spec, gen, dev, dtype) for spec in specs)
    params["layers"] = layers if lazy else list(layers)
    return params


def from_jax_params(tree: dict, cfg: ModelConfig, device="cpu") -> dict:
    """The reference's ``init_params`` pytree, given as numpy arrays, as
    the port's params: the prologue layers, then the stacked ``period``
    axis unrolled into ``layers`` (expert leaves keep their ``(E, ·, ·)``
    stack); ``head`` is kept when present (tied models read ``embed.T`` at
    use, as the reference's ``_head_weight`` does); an ``encoder`` subtree
    (its stacked ``period`` of one layer, and ``final_norm``) becomes
    ``{"layers", "final_norm"}``."""
    pro, period, nper = cfg.layer_plan()

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    params = {k: t(tree[k]) for k in ("embed", "final_norm", "head")
              if k in tree}
    if "encoder" in tree:
        enc = tree["encoder"]
        params["encoder"] = {
            "layers": [{k: t(np.asarray(v)[i])
                        for k, v in enc["period"][0].items()}
                       for i in range(cfg.encoder_layers)],
            "final_norm": t(enc["final_norm"])}
    params["layers"] = [{k: t(v) for k, v in tree["prologue"][i].items()}
                        for i in range(len(pro))]
    params["layers"] += [
        {k: t(np.asarray(v)[i]) for k, v in tree["period"][j].items()}
        for i in range(nper) for j in range(len(period))]
    return params


def from_jax_train_state(opt_state: dict, err_state: dict,
                         cfg: ModelConfig, device="cpu") -> tuple:
    """The reference trainer's optimizer state ``{"step", "m", "v"}`` and
    error-feedback state, given as numpy arrays, as the port's: the
    moments and the residuals are parameter-shaped trees
    (:func:`from_jax_params`); without compression the reference carries
    the placeholder ``{"_": 0}``, kept as it is."""
    opt = {"step": torch.tensor(int(np.asarray(opt_state["step"])),
                                dtype=torch.int32, device=device),
           "m": from_jax_params(opt_state["m"], cfg, device),
           "v": from_jax_params(opt_state["v"], cfg, device)}
    if "_" in err_state:
        err = {"_": torch.from_numpy(np.array(err_state["_"])).to(device)}
    else:
        err = from_jax_params(err_state, cfg, device)
    return opt, err


def _head_weight(params: dict) -> torch.Tensor:
    return params["head"] if "head" in params else params["embed"].T


def fused_site_matrix(cfg: ModelConfig, stamp: Optional[StampConfig]
                      ) -> dict:
    """Eligibility audit: every STaMP site this architecture instantiates,
    mapped to ``fused`` or ``reference`` with reason codes (the
    reference's ``lm.fused_site_matrix``).  Cells: ``{"status", "kernel",
    "wiring", "layers", "reasons"}`` keyed by the telemetry site label
    (``qkv`` / ``wo`` / ``gate_up`` / ``wo_mlp`` / ``moe`` / ``in_proj`` /
    ``out_proj`` / ``cross_attn`` / ``encoder``).  Cross-attention and the
    encoder never run the fused kernels, whatever the config: a site
    reason replaces the config's."""
    base = (("stamp_disabled",) if stamp is None
            else fused_ineligibility(stamp))
    matrix: dict = {}

    def add(site, kernel, wiring, site_reasons=()):
        reasons = tuple(site_reasons) or base
        cell = matrix.setdefault(site, {
            "status": "fused" if not reasons else "reference",
            "kernel": kernel if not reasons else None,
            "wiring": wiring, "layers": 0, "reasons": list(reasons)})
        cell["layers"] += 1

    for spec in cfg.layer_specs():
        if spec.mixer == "attn":
            add("qkv", "stamp_quant_matmul", "merged_wqkv")
            add("wo", "stamp_quant_matmul", "single_head_merge")
        elif spec.mixer == "mamba":
            add("in_proj", "stamp_quant_matmul", "single")
            add("out_proj", "stamp_quant_matmul", "single")
        if spec.ffn in ("mlp", "moe_dense"):
            add("gate_up", "stamp_quant_dual_matmul", "pair")
            add("wo_mlp", "stamp_quant_matmul", "single")
        if spec.ffn in ("moe", "moe_dense"):
            add("moe", "stamp_quant_grouped_matmul", "grouped_dispatch")
    if cfg.encoder_layers:
        # pooled conditioning carries no sequence transform (the paper's
        # Table 4), and the encoder runs unquantized
        for _ in cfg.layer_specs():
            add("cross_attn", None, "reference_xattn",
                ("site_cross_attn_no_seq_transform",))
        for _ in range(cfg.encoder_layers):
            add("encoder", None, "reference_encoder",
                ("site_encoder_unstamped",))
    return matrix


# ---------------------------------------------------------------------------
# (possibly quantized) linears and weight preparation
# ---------------------------------------------------------------------------


def _dequant_packed(w: dict, dtype) -> torch.Tensor:
    q = KV.unpack_nibbles(w["q"].transpose(-1, -2)).to(dtype)
    q = q.transpose(-1, -2)                                  # (din, dout)
    return (q - w["zp"].to(dtype)) * w["scale"].to(dtype)


def _weight(w, dtype) -> torch.Tensor:
    """A plain tensor, a packed-int4 dict ``{"q", "scale", "zp"}`` or a
    prepared int8 dict ``{"iq", "isw", "izw", "iqsum"}`` as a dense
    ``(din, dout)`` weight in ``dtype``."""
    if isinstance(w, dict) and "iq" in w:
        # codes and zero points are small integers: exact in bf16
        return (w["iq"].to(dtype) - w["izw"].to(dtype)) * w["isw"].to(dtype)
    if isinstance(w, dict):
        return _dequant_packed(w, dtype)
    return w.to(dtype)


def _decodes(x: torch.Tensor, w, decode_matmul: bool) -> bool:
    """Whether ``x @ w`` takes the decode kernel K3: decode-shaped input
    (one token per slot) over prepared weights, with ``decode_matmul``."""
    return isinstance(w, dict) and "iq" in w and decode_matmul and \
        x.ndim >= 2 and x.shape[-2] == 1


def _linear(x: torch.Tensor, w, b=None, decode_matmul: bool = False,
            f32_sum: bool = False,
            split: Optional[ModelSplit] = None) -> torch.Tensor:
    """Matmul over a plain tensor, a packed-int4 dict or a prepared int8
    dict (:func:`_weight`).  With ``decode_matmul``, decode-shaped input
    (one token per slot) over prepared weights runs the decode kernel on
    the int8 codes.  With ``f32_sum`` the product is taken as the
    reference's compiled programs take a bf16 one: f32 sums of the bf16
    operands, rounded once to ``x``'s dtype (a bf16 matmul on the CPU sums
    in its own order, and on the card may reduce in bf16, moving a value
    by a bf16 step now and then) — the encoder's and the cross-attention's
    plain linears, whose outputs are held bit for bit.  A model ``split``
    marks ``x`` as a row-parallel block: the result is this rank's part of
    the sum, in f32 under the split's ``f32_parts`` (:func:`_row_linear`
    sums it)."""
    f32_part = split is not None and split.f32_parts
    if _decodes(x, w, decode_matmul):
        if split is not None:
            raise ValueError("a row-parallel decode product is summed over "
                             "the ranks before K3's epilogue: _row_linear")
        lead = x.shape[:-1]
        y = stamp_decode_matmul(x.reshape(-1, x.shape[-1]), w["iq"], w["isw"],
                                w["izw"], w["iqsum"], b, out_dtype=x.dtype)
        return y.reshape(*lead, y.shape[-1])
    if f32_part:
        y = x.float() @ _weight(w, x.dtype).float()
        return y + b.float() if b is not None else y
    if f32_sum:
        y = (x.float() @ _weight(w, x.dtype).float()).to(x.dtype)
    else:
        y = x @ _weight(w, x.dtype)
    return y + b.to(x.dtype) if b is not None else y


def _row_linear(x: torch.Tensor, w, dm: bool,
                split: Optional[ModelSplit], dtype) -> torch.Tensor:
    """A row-parallel product without bias (``x`` this rank's block of the
    input features, ``w`` its rows) summed over the model ranks, in
    ``dtype`` (the whole product without a split).  Decode-shaped input
    over prepared weights (``dm``) takes K3 as one device does: the block
    quantized with the whole rows' statistics (K3's statistics mode, its
    all-reduce), its int32 products and row sums (K3's parts mode) summed
    over the ranks (an integer all-reduce, exact) and finished once (its
    summed mode): one device's output bit for bit.  Otherwise the ranks'
    parts leave through a reduce-out (each in f32, rounded once, under
    the split's ``f32_parts``)."""
    if split is None or not _decodes(x, w, dm):
        return _reduced(_linear(x, w, None, dm, split=split), split, dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    part = decode_row_minmax(x2)
    stats = torch.stack(split.minmax(part[:, 0], part[:, 1]), -1)
    parts = split.sum(stamp_decode_matmul_parts(x2, w["iq"], w["iqsum"],
                                                stats))
    y = stamp_decode_matmul_summed(parts, stats, w["isw"], w["izw"],
                                   out_dtype=dtype)
    return y.reshape(*lead, y.shape[-1])


def _use_fused(stamp: Optional[StampConfig], w) -> bool:
    return (stamp is not None and stamp.enabled
            and stamp.execution == "fused"
            and isinstance(w, dict) and "iq" in w)


def pack_weight(w: torch.Tensor, bits: int = 4) -> dict:
    """(din, dout) → packed int4 dict; per-output-channel min-max scales,
    two codes per byte along din."""
    n = float(2 ** bits - 1)
    wf = w.float()
    mn = wf.amin(dim=-2, keepdim=True)
    mx = wf.amax(dim=-2, keepdim=True)
    scale = torch.clamp_min(fdiv(mx - mn, n), EPS)
    zp = torch.round(-mn / scale)
    q = torch.clamp(torch.round(wf / scale) + zp, 0.0, n)
    packed = KV.pack_nibbles(q.transpose(-1, -2))
    return {"q": packed.transpose(-1, -2).contiguous(), "scale": scale,
            "zp": zp}


_BIG = ("wq", "wk", "wv", "wo", "xwq", "xwk", "xwv", "xwo", "wi_gate",
        "wi_up", "wo_mlp", "dwi_gate", "dwi_up", "dwo_mlp", "we_gate",
        "we_up", "we_down", "in_proj", "out_proj")
_EXPERTS = ("we_gate", "we_up", "we_down")
# the sites prepare_fused_weights codes one by one (wq / wk / wv merge)
_SINGLE = ("wo", "wi_gate", "wi_up", "wo_mlp", "dwi_gate", "dwi_up",
           "dwo_mlp", "in_proj", "out_proj")
_ENCODER_SPEC = LayerSpec("attn", "mlp")


def _one_expert(w, e: int):
    return {k: v[e] for k, v in w.items()} if isinstance(w, dict) else w[e]


def _per_expert(fn, w) -> dict:
    """``fn`` (a ``(din, dout)`` weight or packed dict → dict of tensors)
    over a stacked ``(E, ·, ·)`` weight one expert at a time, stacked into
    preallocated outputs: its f32 temporaries stay one expert's size.
    Under a ``FakeTensorMode`` only the first expert runs: its outputs'
    shapes are every expert's, and fake tensors hold no values."""
    first = fn(_one_expert(w, 0))
    n = (next(iter(w.values())) if isinstance(w, dict) else w).shape[0]
    out = {k: v.new_empty((n, *v.shape)) for k, v in first.items()}
    if fake_mode_active():
        return out
    for e in range(n):
        part = first if e == 0 else fn(_one_expert(w, e))
        for k, v in part.items():
            out[k][e] = v
    return out


def quantize_weights_for_serving(layer: dict, bits: int = 4) -> dict:
    """Pack one layer's large matmul weights to int4 (expert stacks one
    expert at a time); norms, biases and the router stay as they are."""
    return {k: (_per_expert(lambda w: pack_weight(w, bits), v)
                if k in _EXPERTS else pack_weight(v, bits))
            if k in _BIG else v for k, v in layer.items()}


def _prep(w, bits: int) -> dict:
    raw = _dequant_packed(w, torch.float32) if isinstance(w, dict) \
        else w.float()
    p = prepare_linear(raw, bits=bits)
    return {"iq": p.qw, "isw": p.sw, "izw": p.zw, "iqsum": p.qw_sum}


def _prep_down_expert(w, bits: int) -> dict:
    """One expert's down-projection, with the per-slab column sums the
    grouped kernel's slab epilogues read."""
    p = _prep(w, bits)
    p["iqslab"] = down_slab_sums(p["iq"][None])[0]
    return p


def prepare_fused_weights(params: dict, stamp: StampConfig,
                          split: Optional[ModelSplit] = None) -> dict:
    """Hoist every fused site's weights into int8 buffers ``{"iq", "isw",
    "izw", "iqsum"}``, one layer at a time: wq/wk/wv merge into ``wqkv``
    (biases into ``bqkv``), gate/up, the out-projections and the Mamba
    in/out projections prepare per site, expert stacks one expert at a time (``we_down`` also keeps its
    per-slab sums ``iqslab``).  Packed int4 weights are dequantized and
    re-coded at ``stamp.fused_weight_bits``.  The cross-attention weights
    ``xw*`` and the encoder stay as they are: no sequence transform runs
    at those sites, and the encoder runs unquantized.
    ``params["layers"]`` may be
    an iterator: a layer handed over that way is dropped as soon as it is
    prepared.  No-op when the config cannot run the fused kernels.

    Under a model ``split`` (``params`` whole) each site is prepared from
    its whole weight, so every per-column scale, zero point and code is
    one device's, and this rank's block is kept (:func:`model_blocks`:
    ``wqkv`` as ``[wq block | wk block | wv block]``, ``in_proj`` cut by
    parts as :func:`_mixer_blocks` cuts it, a row-parallel site's rows
    (``out_proj``'s too) with its whole columns' ``isw`` / ``izw`` and
    its own rows' ``iqsum``); expert stacks prepare only this rank's
    experts."""
    if not fused_eligible(stamp):
        return model_blocks(params, split)
    bits = stamp.fused_weight_bits
    layers = []
    coded = ("wq", "wk", "wv", "bq", "bk", "bv") + _SINGLE + _EXPERTS
    for p in params["layers"]:
        if split is not None:
            p = {k: _expert_block(v, split) if k in _EXPERTS else v
                 for k, v in p.items()}
        out = {k: v for k, v in p.items() if k not in coded}
        widths = None
        if "wq" in p:
            raws = [_dequant_packed(p[k], torch.float32)
                    if isinstance(p[k], dict) else p[k].float()
                    for k in ("wq", "wk", "wv")]
            widths = [r.shape[-1] for r in raws]
            out["wqkv"] = _prep(torch.cat(raws, dim=-1), bits)
            del raws
        if all(k in p for k in ("bq", "bk", "bv")):
            out["bqkv"] = torch.cat([p["bq"], p["bk"], p["bv"]], dim=-1)
        for k in _SINGLE:
            if k in p:
                out[k] = _prep(p[k], bits)
        for k in _EXPERTS:
            if k in p:
                fn = _prep_down_expert if k == "we_down" else _prep
                out[k] = _per_expert(lambda w: fn(w, bits), p[k])
        if split is not None:
            out = _layer_blocks(out, split, widths, experts=False)
        layers.append(out)
    return model_blocks({**{k: v for k, v in params.items()
                            if k != "layers"}, "layers": layers}, split,
                        layers=False)


# the model axis's split of a layer's leaves (the rule table's ``model``
# dims): column-parallel sites keep their output columns, row-parallel
# ones their input rows (``out_proj``'s d_inner rows fall on head
# boundaries), expert stacks their experts, a Mamba mixer's leaves their
# heads' parts (:func:`_mixer_blocks`); the rest (norms, the router) stay
# whole
_COLS = ("wq", "wk", "wv", "xwq", "xwk", "xwv", "wi_gate", "wi_up",
         "dwi_gate", "dwi_up", "bq", "bk", "bv")
_ROWS = ("wo", "xwo", "wo_mlp", "dwo_mlp", "out_proj")
_MIXER = ("in_proj", "conv_w", "a_log", "dt_bias", "d_skip", "ssm_norm")


def _block(t: torch.Tensor, dim: int, i0: int, i1: int) -> torch.Tensor:
    return t.narrow(dim, i0, i1 - i0).contiguous()


def _cols_block(w, split: ModelSplit):
    """A column-parallel leaf's output columns (a plain weight or bias, a
    packed or prepared dict: every leaf along its last dim)."""
    if isinstance(w, dict):
        return {k: _cols_block(v, split) for k, v in w.items()}
    c0, c1 = split.block(w.shape[-1])
    return _block(w, -1, c0, c1)


def _rows_block(w, split: ModelSplit):
    """A row-parallel leaf's input rows: a plain weight's; a packed dict's
    codes (two rows a byte) with its whole columns' ``scale`` / ``zp``; a
    prepared dict's codes with its whole columns' ``isw`` / ``izw`` and
    the block's own column sums ``iqsum``."""
    if not isinstance(w, dict):
        r0, r1 = split.block(w.shape[-2])
        return _block(w, -2, r0, r1)
    if "iq" in w:
        r0, r1 = split.block(w["iq"].shape[-2])
        iq = _block(w["iq"], -2, r0, r1)
        return {**w, "iq": iq,
                "iqsum": iq.sum(dim=-2, keepdim=True, dtype=torch.int32)}
    din = 2 * w["q"].shape[-2]
    r0, r1 = split.block(din)
    if r0 % 2 or r1 % 2:
        raise ValueError(f"a packed block of {r1 - r0} rows splits a byte")
    return {**w, "q": _block(w["q"], -2, r0 // 2, r1 // 2)}


def _expert_block(w, split: ModelSplit):
    """An expert stack's (or its packed / prepared dict's) experts
    ``[e0, e1)`` of this rank."""
    if isinstance(w, dict):
        return {k: _expert_block(v, split) for k, v in w.items()}
    e0, e1 = split.block(w.shape[0])
    return _block(w, 0, e0, e1)


def _qkv_block(w, split: ModelSplit, widths) -> dict:
    """``wqkv`` (or ``bqkv``) whole → ``[wq block | wk block | wv block]``
    (each leaf along its last dim), so the split ``q`` / ``k`` / ``v``
    come out of one product."""
    if isinstance(w, dict):
        return {k: _qkv_block(v, split, widths) for k, v in w.items()}
    parts = torch.split(w, list(widths), dim=-1)
    return torch.cat([_cols_block(t, split) for t in parts], dim=-1)


def _mixer_dims(p: dict) -> tuple:
    """A Mamba layer's ``(d_inner, state, heads)`` from its whole leaves."""
    di = p["ssm_norm"].shape[-1]
    return di, (p["conv_w"].shape[-1] - di) // 2, p["a_log"].shape[-1]


def mixer_widths(cfg: ModelConfig, split: Optional[ModelSplit] = None
                 ) -> list:
    """The widths of ``in_proj``'s output ``[z | x B C | dt | pad]``: the
    whole projection's (no pad), or under a model ``split`` this rank's
    (:func:`_mixer_blocks`), its dt block padded with zero columns to a
    multiple of 4 (K2 and K3 take N in multiples of 4; the reference has
    no such limit)."""
    n = 1 if split is None else split.size
    if split is not None:
        split.block(cfg.ssm_heads)              # whole heads a rank
    di, h = cfg.d_inner // n, cfg.ssm_heads // n
    return [di, di + 2 * cfg.ssm_state, h,
            0 if split is None else _dt_pad(di, cfg.ssm_state, h)]


def _dt_pad(di: int, n: int, h: int) -> int:
    """Zero columns after a rank's ``in_proj`` block of ``di`` x channels,
    state ``n`` and ``h`` heads: its width up to a multiple of 4."""
    return -(2 * di + 2 * n + h) % 4


def _parts(t: torch.Tensor, parts, pad: int = 0) -> torch.Tensor:
    """``t``'s ``[start, stop)`` ranges of its last dim concatenated, then
    ``pad`` zero columns."""
    cols = [t[..., a:b] for a, b in parts]
    if pad:
        cols.append(t.new_zeros((*t.shape[:-1], pad)))
    return torch.cat(cols, dim=-1)


def _mixer_blocks(p: dict, split: ModelSplit) -> dict:
    """A Mamba layer's mixer leaves (:data:`_MIXER`, whole) as this rank's
    blocks of its heads ``[h0, h1)``: ``in_proj``'s columns ``[z block | x
    block | B | C | dt block | pad]`` (every leaf of a packed or prepared
    dict along its last dim: prepared whole, then cut, so every code,
    scale and zero point is one device's; the pad's columns are zeros,
    :func:`mixer_widths`), ``conv_w``'s channels ``[x block | B | C]``,
    ``a_log`` / ``dt_bias`` / ``d_skip`` the heads', ``ssm_norm`` the
    d_inner block's.  B and C stay whole: with one group every head reads
    them.  Heads the axis does not divide are refused
    (:meth:`ModelSplit.block`)."""
    di, n, h = _mixer_dims(p)
    h0, h1 = split.block(h)
    hd = di // h
    x0, x1 = h0 * hd, h1 * hd
    cut = {"in_proj": ([(x0, x1), (di + x0, di + x1),
                        (2 * di, 2 * di + 2 * n),
                        (2 * di + 2 * n + h0, 2 * di + 2 * n + h1)],
                       _dt_pad(x1 - x0, n, h1 - h0)),
           "conv_w": ([(x0, x1), (di, di + 2 * n)], 0),
           "a_log": ([(h0, h1)], 0), "dt_bias": ([(h0, h1)], 0),
           "d_skip": ([(h0, h1)], 0), "ssm_norm": ([(x0, x1)], 0)}

    def one(w, parts, pad):
        if isinstance(w, dict):
            return {k: one(v, parts, pad) for k, v in w.items()}
        return _parts(w, parts, pad)
    return {k: one(v, *cut[k]) if k in cut else v for k, v in p.items()}


def _layer_blocks(p: dict, split: ModelSplit, widths=None,
                  experts: bool = True) -> dict:
    """One layer's leaves, whole, as this rank's blocks (``widths``: the
    ``q`` / ``k`` / ``v`` widths of a merged ``wqkv``; ``experts=False``:
    its expert stacks are this rank's already)."""
    if "a_log" in p:
        p = _mixer_blocks(p, split)
    out = {}
    for k, v in p.items():
        if k in _COLS:
            v = _cols_block(v, split)
        elif k in _ROWS:
            v = _rows_block(v, split)
        elif k in _EXPERTS and experts:
            v = _expert_block(v, split)
        elif k in ("wqkv", "bqkv"):
            if widths is None:
                raise ValueError("a merged wqkv needs its q / k / v widths")
            v = _qkv_block(v, split, widths)
        out[k] = v
    return out


def model_blocks(params: dict, split: Optional[ModelSplit],
                 cfg: Optional[ModelConfig] = None,
                 layers: bool = True) -> dict:
    """A whole parameter tree (plain, packed or prepared) as this rank's
    blocks under a model ``split``, the leaves ``prefill`` /
    ``decode_step`` take as plain tensors under a policy: each layer's
    (:func:`_layer_blocks`; a merged ``wqkv`` needs ``cfg`` for its
    widths; a Mamba mixer's heads: :func:`_mixer_blocks`), the
    encoder's, and the embedding's vocabulary rows and the
    head's vocabulary columns.  Packing or preparing the whole tree first
    and then taking the blocks keeps every per-column scale, zero point
    and code one device's.  ``None``: ``params`` itself."""
    if split is None:
        return params
    widths = None if cfg is None else _qkv_widths(cfg)
    out = dict(params)
    if "embed" in params:
        v0, v1 = split.block(params["embed"].shape[0])
        out["embed"] = _block(params["embed"], 0, v0, v1)
    if "head" in params:
        out["head"] = _cols_block(params["head"], split)
    if layers:
        out["layers"] = [_layer_blocks(p, split, widths)
                         for p in params["layers"]]
    if "encoder" in params:
        out["encoder"] = {**params["encoder"], "layers": [
            _layer_blocks(p, split) for p in params["encoder"]["layers"]]}
    return out


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _maybe_stamp(x: torch.Tensor, stamp: Optional[StampConfig],
                 site: Optional[str] = None,
                 split: Optional[ModelSplit] = None):
    """STaMP's round trip of ``x`` (itself without STaMP); a model
    ``split`` marks ``x`` as a row-parallel block, quantized with the
    whole rows' statistics."""
    if stamp is None or not stamp.enabled:
        return x
    return stamp_fake_quant(x, stamp, site=site, split=split)


def _split_heads(x: torch.Tensor, nh: int, hd: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], nh, hd)


def _rope(flat, positions, cfg: ModelConfig, nh: int, hd: int):
    return L.apply_rope(_split_heads(flat, nh, hd), positions,
                        cfg.rope_theta)


def _qkv_widths(cfg: ModelConfig, split: Optional[ModelSplit] = None
                ) -> list:
    """The ``q`` / ``k`` / ``v`` widths of a merged ``wqkv``: the whole
    projections', or under a model ``split`` its ``[wq | wk | wv]``
    blocks' (:func:`_qkv_block`)."""
    n = 1 if split is None else split.size
    return [cfg.q_dim // n, cfg.kv_dim // n, cfg.kv_dim // n]


def _attn_qkv(p: dict, h: torch.Tensor, cfg: ModelConfig,
              stamp: Optional[StampConfig], dm: bool,
              split: Optional[ModelSplit] = None) -> tuple:
    """QKV projections (shared by every path); a merged ``wqkv`` splits at
    :func:`_qkv_widths` (under a model ``split``, this rank's blocks')."""
    if "wqkv" in p:
        bqkv = p.get("bqkv")
        if _use_fused(stamp, p["wqkv"]):
            qkv = L.stamp_fused_linear(h, p["wqkv"], bqkv, stamp,
                                       site="qkv")
        else:
            qkv = _linear(_maybe_stamp(h, stamp, "qkv"), p["wqkv"], bqkv,
                          dm)
        return torch.split(qkv, _qkv_widths(cfg, split), dim=-1)
    h = _maybe_stamp(h, stamp, "qkv")
    return (_linear(h, p["wq"], p.get("bq"), dm),
            _linear(h, p["wk"], p.get("bk"), dm),
            _linear(h, p["wv"], p.get("bv"), dm))


def _attn_out(p: dict, attn: torch.Tensor, x: torch.Tensor,
              stamp: Optional[StampConfig], dm: bool,
              split: Optional[ModelSplit] = None) -> torch.Tensor:
    """Out-projection of the attention output (head-split, or flat) +
    residual; under a model ``split`` row-parallel over this rank's flat
    ``q_dim`` block, STaMP's per-token statistics all-reduced over the
    model ranks."""
    if attn.ndim == x.ndim + 1:
        attn = attn.reshape(*attn.shape[:-2], -1)
    if _use_fused(stamp, p["wo"]):
        return x + L.stamp_fused_linear(attn, p["wo"], None, stamp,
                                        site="wo", split=split)
    out = _maybe_stamp(attn, stamp, "wo", split)
    return x + _row_linear(out, p["wo"], dm, split, x.dtype)


class _ExpertStack:
    """Expert ``e``'s ``(din, dout)`` weight of a stacked prepared-int8 or
    packed-int4 expert dict, dequantized in ``dtype`` when indexed — the
    reference's ``_expert_w`` one expert at a time (a whole Arctic stack in
    bf16 is 8.9 GB)."""

    def __init__(self, w, dtype):
        self.w, self.dtype = w, dtype

    def __getitem__(self, e: int) -> torch.Tensor:
        return _weight(_one_expert(self.w, e), self.dtype)


def ffn_block(p: dict, x: torch.Tensor, spec: LayerSpec, cfg: ModelConfig,
              stamp: Optional[StampConfig], dm: bool,
              split: Optional[ModelSplit] = None) -> torch.Tensor:
    """SwiGLU MLP and/or MoE + residual, summed as the reference does: ``x
    + ((0 + moe) + mlp)``.  The fused MLP is one dual call for gate/up and
    one call for the down-projection; the fused MoE routes on the stamped
    round trip and runs the expert stack through the grouped kernel.
    Without fused weights or STaMP (the decode region, calibration) the
    MoE runs the reference FFN over the routed experts only.  A pure-SSM
    layer has no FFN (``none``).  Without STaMP the FFN is
    :func:`_ffn_plain`.  Under a model ``split`` the leaves are this
    rank's blocks: gate / up column-parallel on the whole (replicated)
    rows, the down-projection row-parallel with STaMP's per-token
    statistics all-reduced over the model ranks, every row routed on
    every rank and only this rank's experts computed; the MoE's and the
    MLP's parts are each summed over the ranks."""
    if spec.ffn == "none":
        return x
    h = L.rms_norm(x, p["ln2"].to(x.dtype), cfg.norm_eps)
    if stamp is None or not stamp.enabled:
        return x + _ffn_plain(p, _copy_in(h, split), spec, cfg, dm, split)
    experts = None if split is None else split.block(cfg.num_experts)
    hq = None
    out = torch.zeros_like(x)
    if spec.ffn in ("moe", "moe_dense"):
        hq = _maybe_stamp(h, stamp, "moe")
        route = (cfg.experts_per_token, cfg.capacity_factor,
                 cfg.moe_group_size)
        f32 = split is not None and split.f32_parts
        if all(_use_fused(stamp, p[k]) for k in _EXPERTS):
            moe = L.moe_ffn_fused(hq, p["gate_w"], p["we_gate"], p["we_up"],
                                  p["we_down"], *route, experts=experts,
                                  part_f32=f32)
        else:
            moe = L.moe_ffn(hq, p["gate_w"], *(
                _ExpertStack(p[k], x.dtype) for k in _EXPERTS), *route,
                experts=experts, part_f32=f32)
        out = out + _reduced(moe, split, x.dtype)
    if spec.ffn in ("mlp", "moe_dense"):
        pre = "d" if spec.ffn == "moe_dense" else ""
        wg, wu, wo = p[f"{pre}wi_gate"], p[f"{pre}wi_up"], p[f"{pre}wo_mlp"]
        if _use_fused(stamp, wg) and _use_fused(stamp, wu):
            g = L.stamp_fused_dual_linear(h, wg, wu, stamp, site="gate_up")
        else:
            hq = _maybe_stamp(h, stamp, "gate_up") if hq is None else hq
            g = silu(_linear(hq, wg, None, dm)) * _linear(hq, wu, None, dm)
        if _use_fused(stamp, wo):
            out = out + L.stamp_fused_linear(g, wo, None, stamp,
                                             site="wo_mlp", split=split)
        else:
            out = out + _row_linear(_maybe_stamp(g, stamp, "wo_mlp", split),
                                    wo, dm, split, x.dtype)
    return x + out


def _copy_in(x: torch.Tensor, split: Optional[ModelSplit]) -> torch.Tensor:
    """A column-parallel block's input: its gradient summed over the model
    ranks (itself without a split)."""
    return x if split is None else split.copy_in(x)


def _reduced(y: torch.Tensor, split: Optional[ModelSplit],
             dtype=None) -> torch.Tensor:
    """A row-parallel product summed over the model ranks (itself
    without a split), then cast to ``dtype`` where given (a sum of f32
    parts rounded once)."""
    y = y if split is None else split.reduce_out(y)
    return y if dtype is None else y.to(dtype)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               positions, cfg: ModelConfig, causal: bool,
               split: Optional[ModelSplit] = None,
               kv_whole: bool = False) -> torch.Tensor:
    """Attention from the flat q, k and v projections to the flat output
    (``wo``'s input); ``positions`` ``None``: no RoPE (cross-attention).
    Under a model ``split`` the projections are this rank's flat blocks,
    and so is the output ``(…, q_dim / size)``.  The blocks rarely fall
    on head boundaries, so k and v are gathered over ``model`` (and q
    too unless its block is whole heads; ``kv_whole``: k and v come
    gathered already); only the query heads that overlap the block are
    computed, each against its KV head (a GQA group's K / V selected per
    query head), and the block is sliced out."""
    hd, nh, kvh = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    h0, h1 = 0, nh
    if split is not None:
        q0, q1 = split.block(cfg.q_dim)
        h0, h1 = q0 // hd, -(-q1 // hd)
        if q0 % hd or q1 % hd:
            q = split.gather(q, -1)[..., h0 * hd:h1 * hd]
        if not kv_whole:
            k, v = split.gather(k, -1), split.gather(v, -1)
    q = _split_heads(q, h1 - h0, hd)
    k, v = _split_heads(k, kvh, hd), _split_heads(v, kvh, hd)
    if split is not None:
        groups = torch.arange(h0, h1, device=q.device) // (nh // kvh)
        k, v = k.index_select(-2, groups), v.index_select(-2, groups)
    if positions is not None:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    attn = L.flash_attention(q, k, v, causal=causal)
    attn = attn.reshape(*attn.shape[:-2], -1)
    if split is None:
        return attn
    return attn[..., q0 - h0 * hd:q1 - h0 * hd]


def _ffn_plain(p: dict, h: torch.Tensor, spec: LayerSpec, cfg: ModelConfig,
               dm: bool, split: Optional[ModelSplit] = None) -> torch.Tensor:
    """The FFN without STaMP, from the normed input ``h``: the MLP's
    ``silu(h wi_gate) · h wi_up`` through ``wo_mlp``, after the MoE's
    reference FFN over the routed experts.  Under a model ``split`` ``h``
    has passed its copy-in, and the MLP's and the experts' parts are
    summed over the ranks (in one reduce-out; each in f32, rounded once,
    under the split's ``f32_parts``, the down-projection's decode rows
    through :func:`_row_linear`): gate and up column-parallel,
    ``silu·mul`` on the block, the down-projection row-parallel; the MoE
    routes every row (the router replicated, its weight's gradient summed
    over the model ranks by a copy-in: each rank's part comes through its
    own experts) and computes only this rank's ``E / size`` experts."""
    f32 = split is not None and split.f32_parts

    def part(y):
        return _reduced(y, split, h.dtype) if f32 else y

    out = torch.zeros_like(h)
    if spec.ffn in ("moe", "moe_dense"):
        out = out + part(L.moe_ffn(h, _copy_in(p["gate_w"], split), *(
            _ExpertStack(p[k], h.dtype) for k in _EXPERTS),
            cfg.experts_per_token, cfg.capacity_factor, cfg.moe_group_size,
            experts=None if split is None else split.block(cfg.num_experts),
            part_f32=f32))
    if spec.ffn in ("mlp", "moe_dense"):
        pre = "d" if spec.ffn == "moe_dense" else ""
        g = silu(_linear(h, p[f"{pre}wi_gate"], None, dm)) * \
            _linear(h, p[f"{pre}wi_up"], None, dm)
        wo = p[f"{pre}wo_mlp"]
        out = out + (_row_linear(g, wo, dm, split, h.dtype) if f32 else
                     _linear(g, wo, None, dm, split=split))
    return out if f32 else _reduced(out, split)


def attn_block_prefill(p: dict, x: torch.Tensor, cfg: ModelConfig,
                       stamp: Optional[StampConfig],
                       kv: Optional[KV.KVCacheConfig] = None,
                       capacity: Optional[int] = None,
                       enc_out: Optional[torch.Tensor] = None,
                       split: Optional[ModelSplit] = None,
                       group: Optional[SeqGroup] = None) -> tuple:
    """Causal self-attention over whole sequences: QKV (the fused STaMP
    linear over prepared weights, or the reference path), RoPE, attention,
    out-projection; then, given the encoder output ``enc_out``, the
    layer's cross-attention.  With ``kv`` it also returns the layer's
    contiguous cache, quantized from the RoPE'd K and V with room for
    ``capacity`` tokens (the bucketed engine's prefill), with the
    cross-attention's bf16 ``xk`` / ``xv`` beside them; without, ``None``
    (the calibration forward).  Under a model ``split`` the layer's
    leaves are this rank's blocks: column-parallel QKV (STaMP over the
    whole, replicated rows), attention over the heads its block
    overlaps (:func:`_attention`, k and v gathered), row-parallel ``wo``
    (STaMP's per-token statistics all-reduced) summed over the model
    ranks.  Under a sequence ``group`` the cache is this rank's
    :class:`~repro_torch.serving.kvcache.SeqBlock` of it, quantized from
    the whole K / V rows."""
    hd, kvh = cfg.resolved_head_dim, cfg.num_kv_heads
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    h = L.rms_norm(x, p["ln1"].to(x.dtype), cfg.norm_eps)
    entry = None
    if kv is None and (stamp is None or not stamp.enabled):
        q, k, v = _attn_qkv(p, _copy_in(h, split), cfg, None, False, split)
        attn = _attention(q, k, v, positions, cfg, True, split)
        x = x + _reduced(_linear(attn, p["wo"]), split)
    else:
        q, k, v = _attn_qkv(p, h, cfg, stamp, False, split)
        if split is not None:
            k, v = split.gather(k, -1), split.gather(v, -1)
        if kv is not None:
            cap = max(capacity or x.shape[1], x.shape[1])
            entry = KV.quantize_full(
                _rope(k, positions, cfg, kvh, hd), _split_heads(v, kvh, hd),
                kv, capacity=capacity, block=KV.seq_block(kv, cap, group))
        attn = _attention(q, k, v, positions, cfg, True, split,
                          kv_whole=True)
        x = _attn_out(p, attn, x, stamp, False, split)
    if enc_out is not None and "xwq" in p:
        x = cross_attn_block(p, x, enc_out, cfg, stamp, entry, split, group)
    return x, entry


def cross_attn_block(p: dict, x: torch.Tensor, enc_out: torch.Tensor,
                     cfg: ModelConfig, stamp: Optional[StampConfig],
                     entry: Optional[dict] = None,
                     split: Optional[ModelSplit] = None,
                     group: Optional[SeqGroup] = None) -> torch.Tensor:
    """Cross-attention + residual (the reference's enc-dec branch of
    ``attn_block``): queries from the ``lnx``-normed ``x``, keys and values
    from the encoder output, no mask and no RoPE, the projections plain
    linears over their (packed) weights.  Under STaMP the output takes a
    per-token ``lo_bits`` fake quantize and no sequence transform (pooled
    conditioning breaks the Toeplitz structure: the paper's Fig. 5 / Table
    4).  ``entry`` (a prefill's cache entry) receives the bf16 ``xk`` /
    ``xv``.  Its projections take f32 sums of bf16 operands rounded once
    (:func:`_linear`'s ``f32_sum``), so ``xk`` / ``xv`` are the
    reference's bit for bit.  The reference's decode step runs no
    cross-attention (its ``decode_step`` passes no encoder output), so the
    cached ``xk`` / ``xv`` are written here and carried, never read.
    Under a model ``split`` the projections are this rank's blocks, as
    in :func:`attn_block_prefill` (the output's per-token quantize takes
    the whole rows' min / max, all-reduced over the model ranks), and
    under a sequence ``group`` the cached ``xk`` / ``xv`` are this rank's
    block of the encoder positions."""
    hd, kvh = cfg.resolved_head_dim, cfg.num_kv_heads
    hx = L.rms_norm(x, p["lnx"].to(x.dtype), cfg.norm_eps)
    qx = _linear(_copy_in(hx, split), p["xwq"], f32_sum=True)
    enc_out = _copy_in(enc_out, split)
    kx = _linear(enc_out, p["xwk"], f32_sum=True)
    vx = _linear(enc_out, p["xwv"], f32_sum=True)
    if split is not None:
        kx, vx = split.gather(kx, -1), split.gather(vx, -1)
    if entry is not None:
        x0, xn = 0, kx.shape[1]
        if group is not None:
            x0, xn, _ = group.region(xn)
        entry["xk"] = _split_heads(kx, kvh, hd)[:, x0:x0 + xn].to(
            torch.bfloat16)
        entry["xv"] = _split_heads(vx, kvh, hd)[:, x0:x0 + xn].to(
            torch.bfloat16)
    ox = _attention(qx, kx, vx, None, cfg, False, split, kv_whole=True)
    if stamp is not None and stamp.enabled:
        minmax = None if split is None else split.minmax(
            ox.float().amin(dim=-1, keepdim=True),
            ox.float().amax(dim=-1, keepdim=True))
        ox = fake_quant(ox, stamp.lo_bits, compiled=True, minmax=minmax)
    return x + _reduced(_linear(ox, p["xwo"], f32_sum=True, split=split),
                        split, x.dtype)


def attn_block_cached_decode(p: dict, x: torch.Tensor, cfg: ModelConfig,
                             serve: ServeConfig, entry: dict,
                             pos: torch.Tensor, dm: bool,
                             split: Optional[ModelSplit] = None,
                             group: Optional[SeqGroup] = None
                             ) -> torch.Tensor:
    """One token per slot against the contiguous cache: write the token's
    K/V at ``pos`` (scalar or (b,)), then attend over ``pos + 1`` tokens —
    through the packed-cache attention kernel K6 when
    ``fused_cache_attention`` is set, else over the dequantized hi and lo
    segments (or the dense bf16 cache).  An enc-dec entry's ``xk`` /
    ``xv`` stay as they are (no cross-attention at decode, as in the
    reference: :func:`cross_attn_block`).  Under a model ``split`` q, k
    and v are computed column-parallel and gathered whole (they are one
    token a slot) and ``wo`` is row-parallel over this rank's ``q_dim``
    block.  Under a sequence ``group`` (context parallel) the entry is
    this rank's block of the cache of ``serve.cache_capacity`` positions:
    the rank that holds the new token's position writes it, each rank
    attends every head over its block (K6's block mode, or the plain
    segments), and the group's partial softmax states are gathered and
    merged in rank order (K6's merge, or a plain log-sum-exp)."""
    hd, nh, kvh = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    kv = serve.kv
    positions = pos[:, None] if pos.ndim == 1 else pos.reshape(1, 1)
    h = L.rms_norm(x, p["ln1"].to(x.dtype), cfg.norm_eps)
    q, k, v = _attn_qkv(p, h, cfg, None, dm, split)
    if split is not None:
        q, k, v = (split.gather(t, -1) for t in (q, k, v))
    q = _rope(q, positions, cfg, nh, hd)
    k = _rope(k, positions, cfg, kvh, hd)
    length = (pos.reshape(-1) + 1).to(torch.int32).expand(x.shape[0])
    if group is None:
        KV.write_token(entry, k, _split_heads(v, kvh, hd), pos, kv)
        if kv.quantized and serve.fused_cache_attention:
            attn = cache_decode_attention(entry, q, length)
        elif kv.quantized:
            (k_hi, v_hi), (k_lo, v_lo) = KV.dequantize_segments(entry,
                                                                x.dtype)
            attn = L.decode_attention_segments(
                q, [(k_hi, v_hi, 0), (k_lo, v_lo, k_hi.shape[1])],
                length=length)
        else:
            kf, vf = KV.dequantize_full(entry, kv, x.dtype)
            attn = L.decode_attention(q, kf, vf, length=length)
    else:
        if serve.cache_capacity is None:
            raise ValueError("a sequence-split cache needs "
                             "serve.cache_capacity, its whole length")
        blk = KV.seq_block(kv, serve.cache_capacity, group)
        KV.write_token(entry, k, _split_heads(v, kvh, hd), pos, kv, blk)
        hi0 = blk.hi0 if blk.hi_read else NEVER
        lo0 = blk.lo0 if blk.lo_read else NEVER
        if kv.quantized and serve.fused_cache_attention:
            state = cache_decode_attention(entry, q, length, (hi0, lo0))
            attn = merge_states(group.all_gather(state), q.dtype)
        else:
            if kv.quantized:
                (k_hi, v_hi), (k_lo, v_lo) = KV.dequantize_segments(
                    entry, x.dtype)
                segs = [(k_hi, v_hi, hi0), (k_lo, v_lo, lo0)]
            else:
                kf, vf = KV.dequantize_full(entry, kv, x.dtype)
                segs = [(kf, vf, hi0)]
            state = L.decode_attention_state(q, segs, length)
            attn = merge_states_ref(group.all_gather(state), q.dtype)
    if split is not None:
        q0, q1 = split.block(cfg.q_dim)
        attn = attn.reshape(*attn.shape[:-2], -1)[..., q0:q1]
    return _attn_out(p, attn, x, None, dm, split)


def _decode_attention(entry: dict, q_dec, paged: dict, serve: ServeConfig,
                      dtype) -> torch.Tensor:
    pcfg = serve.paged
    if serve.fused_cache_attention and pcfg.quant.quantized:
        return paged_decode_attention(entry, q_dec, paged["dec_lengths"],
                                      paged["dec_ht"], paged["dec_lt"],
                                      pcfg.block_size)
    segs = PKV.gather_segments(entry, paged["dec_ht"], paged["dec_lt"],
                               pcfg, dtype)
    return L.decode_attention_segments(q_dec, segs,
                                       length=paged["dec_lengths"])


def attn_block_decode(p: dict, x: torch.Tensor, cfg: ModelConfig,
                      serve: ServeConfig, entry: dict, paged: dict,
                      dm: bool) -> torch.Tensor:
    """One token per slot: write through the block tables, attend over the
    mapped pages."""
    hd, nh, kvh = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    pos = paged["dec_positions"][:, None]
    h = L.rms_norm(x, p["ln1"].to(x.dtype), cfg.norm_eps)
    q, k, v = _attn_qkv(p, h, cfg, None, dm)
    q = _rope(q, pos, cfg, nh, hd)
    k = _rope(k, pos, cfg, kvh, hd)
    PKV.write_tokens(entry, k, _split_heads(v, kvh, hd), paged["pages"],
                     paged["offsets"], paged["is_hi"], serve.paged)
    attn = _decode_attention(entry, q, paged, serve, x.dtype)
    return _attn_out(p, attn, x, None, dm)


def attn_block_chunk(p: dict, x: torch.Tensor, cfg: ModelConfig,
                     serve: ServeConfig, entry: dict, paged: dict
                     ) -> torch.Tensor:
    """One prefill chunk ``(1, C, d)`` of one request into the paged cache
    (the two-call step): QKV under STaMP, the chunk's K/V written through
    its block table, then the plain chunked attention over the cached
    prefix and the raw chunk, as the reference's ``paged_prefill_chunk``
    runs it whatever ``fused_cache_attention`` says (``start = 0`` masks
    the cached segments out)."""
    hd, nh, kvh = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    stamp = serve.stamp
    pos = paged["positions"]
    h = L.rms_norm(x, p["ln1"].to(x.dtype), cfg.norm_eps)
    q, k, v = _attn_qkv(p, h, cfg, stamp, False)
    q = _rope(q, pos, cfg, nh, hd)
    k = _rope(k, pos, cfg, kvh, hd)
    v = _split_heads(v, kvh, hd)
    PKV.write_chunk(entry, k, v, paged["pages"], paged["offsets"],
                    paged["is_hi"], serve.paged)
    segs = PKV.gather_segments(entry, paged["hi_table"], paged["lo_table"],
                               serve.paged, x.dtype)
    attn = L.chunked_prefill_attention(q, segs, k, v, paged["start"])
    return _attn_out(p, attn, x, stamp, False)


def attn_block_unified(p: dict, x: tuple, cfg: ModelConfig,
                       serve: ServeConfig, entry: dict, paged: dict,
                       dm: bool) -> tuple:
    """One attention block of the unified ragged step: prefill chunk rows
    ``(n_pf, C, d)`` under STaMP and decode slots ``(S, 1, d)`` transform
    free, ONE K/V scatter over the flattened token stream, then attention
    per span — through the paged attention kernel, or the plain segment
    attention (chunks attending to their raw K/V) when it is off."""
    x_pf, x_dec = x
    hd, nh, kvh = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    n_pf, c_len = x_pf.shape[:2]
    s_slots = x_dec.shape[0]
    stamp = serve.stamp
    h_pf = L.rms_norm(x_pf, p["ln1"].to(x_pf.dtype), cfg.norm_eps)
    h_dec = L.rms_norm(x_dec, p["ln1"].to(x_dec.dtype), cfg.norm_eps)
    q_pf, k_pf, v_pf = _attn_qkv(p, h_pf, cfg, stamp, dm)
    q_dec, k_dec, v_dec = _attn_qkv(p, h_dec, cfg, None, dm)
    pos_pf = paged["pf_positions"]
    pos_dec = paged["dec_positions"][:, None]
    q_pf = _rope(q_pf, pos_pf, cfg, nh, hd)
    k_pf = _rope(k_pf, pos_pf, cfg, kvh, hd)
    v_pf = _split_heads(v_pf, kvh, hd)
    q_dec = _rope(q_dec, pos_dec, cfg, nh, hd)
    k_dec = _rope(k_dec, pos_dec, cfg, kvh, hd)
    v_dec = _split_heads(v_dec, kvh, hd)
    k_flat = torch.cat([k_pf.reshape(n_pf * c_len, kvh, hd),
                        k_dec.reshape(s_slots, kvh, hd)])
    v_flat = torch.cat([v_pf.reshape(n_pf * c_len, kvh, hd),
                        v_dec.reshape(s_slots, kvh, hd)])
    PKV.write_ragged(entry, k_flat, v_flat, paged["pages"], paged["offsets"],
                     paged["is_hi"], serve.paged)
    if serve.fused_cache_attention and serve.paged.quant.quantized:
        attn_pf, attn_dec = paged_ragged_attention(
            entry, q_pf, q_dec, paged["span_starts"], paged["span_lengths"],
            paged["span_ht"], paged["span_lt"], serve.paged.block_size)
    else:
        attn_dec = _decode_attention(entry, q_dec, paged, serve,
                                     x_dec.dtype)
        segs_pf = PKV.gather_segments(entry, paged["pf_ht"], paged["pf_lt"],
                                      serve.paged, x_pf.dtype)
        attn_pf = L.chunked_prefill_attention(q_pf, segs_pf, k_pf, v_pf,
                                              paged["pf_start"])
    return (_attn_out(p, attn_pf, x_pf, stamp, dm),
            _attn_out(p, attn_dec, x_dec, None, dm))


# ---------------------------------------------------------------------------
# Mamba2 / SSD blocks
# ---------------------------------------------------------------------------


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``log(1 + exp(x))`` as ``max(x, 0) + log1p(
    exp(−|x|))`` (PyTorch's own switches to ``x`` past a threshold)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _mamba_in(p: dict, x: torch.Tensor, cfg: ModelConfig,
              stamp: Optional[StampConfig], dm: bool,
              split: Optional[ModelSplit] = None) -> tuple:
    """Norm + in-projection + split, shared by every path: the fused STaMP
    linear (K1 → K2) over prepared weights under fused STaMP, else the
    reference linear (the decode kernel K3 for decode-shaped input when
    ``dm``).  Returns ``(z, xbc, dt f32)``.  Under a model ``split``
    ``in_proj`` is column-parallel over this rank's parts
    (:func:`_mixer_blocks`): STaMP quantizes the whole, replicated rows,
    and the padded dt columns are dropped."""
    h = _copy_in(L.rms_norm(x, p["ln1"].to(x.dtype), cfg.norm_eps), split)
    if _use_fused(stamp, p["in_proj"]):
        proj = L.stamp_fused_linear(h, p["in_proj"], None, stamp,
                                    site="in_proj")
    else:
        proj = _linear(_maybe_stamp(h, stamp, "in_proj"), p["in_proj"],
                       None, dm)
    z, xbc, dt_raw, _ = torch.split(proj, mixer_widths(cfg, split), dim=-1)
    return z, xbc, _softplus(dt_raw.float() + p["dt_bias"])


def _gated_norm(y: torch.Tensor, gamma: torch.Tensor, cfg: ModelConfig,
                split: Optional[ModelSplit] = None) -> torch.Tensor:
    """RMSNorm of the gated ``y`` over d_inner (f32 statistics, scaling
    in ``y``'s dtype, as :func:`~repro_torch.models.layers.rms_norm`),
    its f32 sum of squares taken a head at a time, then over the heads.
    Under a model ``split`` ``y`` is this rank's heads' block: their sums
    are gathered over the model ranks (b·s·heads floats a layer, where
    the reference's partitioned program all-reduces b·s) and summed as
    one device sums them, so each row's statistic is one device's bit for
    bit."""
    part = y.float().square().reshape(*y.shape[:-1], -1,
                                      cfg.ssm_head_dim).sum(dim=-1)
    if split is not None:
        part = split.gather(part, -1)
    var = part.sum(dim=-1, keepdim=True) / cfg.d_inner
    return (y * torch.rsqrt(var + cfg.norm_eps).to(y.dtype)) * \
        gamma.to(y.dtype)


def _mamba_out(p: dict, yh: torch.Tensor, z: torch.Tensor,
               x: torch.Tensor, cfg: ModelConfig,
               stamp: Optional[StampConfig], dm: bool,
               split: Optional[ModelSplit] = None) -> torch.Tensor:
    """Gate + norm + out-projection + residual (decode passes ``stamp =
    None``: no transform, the decode kernel when ``dm``).  Under a model
    ``split`` ``yh`` is this rank's heads, the norm's per-head sums are
    gathered (:func:`_gated_norm`) and ``out_proj`` is row-parallel
    over their d_inner rows, as ``wo`` is (:func:`_attn_out`: STaMP's
    per-token statistics all-reduced; K1 → K2 parts summed before one
    epilogue in prefill, K3's likewise in decode: :func:`_row_linear`)."""
    y = yh.reshape(*yh.shape[:-2], -1).to(x.dtype)
    y = _gated_norm(y * silu(z), p["ssm_norm"], cfg, split)
    if _use_fused(stamp, p["out_proj"]):
        return x + L.stamp_fused_linear(y, p["out_proj"], None, stamp,
                                        site="out_proj", split=split)
    return x + _row_linear(_maybe_stamp(y, stamp, "out_proj", split),
                           p["out_proj"], dm, split, x.dtype)


def _split_xbc(xbc: torch.Tensor, cfg: ModelConfig) -> tuple:
    """``xbc`` (…, d + 2n) → x heads (…, d / head_dim, head_dim), B, C: the
    whole d_inner, or a rank's block of it under a model split."""
    n = cfg.ssm_state
    x_ssm, b_mat, c_mat = torch.split(
        xbc, [xbc.shape[-1] - 2 * n, n, n], dim=-1)
    return (x_ssm.reshape(*x_ssm.shape[:-1], -1, cfg.ssm_head_dim), b_mat,
            c_mat)


def _mamba_step(p: dict, xbc: torch.Tensor, dt: torch.Tensor,
                state: torch.Tensor, conv_cache: torch.Tensor,
                cfg: ModelConfig, dtype) -> tuple:
    """One-token recurrence: ``xbc`` (b, 1, conv_dim), ``dt`` (b, 1, h),
    ``state`` (b, h, p, n) f32, ``conv_cache`` (b, width − 1, conv_dim).
    Returns ``(yh (b, 1, h, p) f32, new state, new conv)``."""
    xp = torch.cat([conv_cache.to(dtype), xbc], dim=1)
    w = p["conv_w"].to(dtype)
    y = sum(xp[:, i:i + 1] * w[i][None, None] for i in range(w.shape[0]))
    xh, b_mat, c_mat = _split_xbc(silu(y), cfg)
    a = -torch.exp(p["a_log"])
    da = torch.exp(dt[:, 0] * a[None])                       # (b, h)
    upd = torch.einsum("bhp,bn,bh->bhpn", xh[:, 0].float(),
                       b_mat[:, 0].float(), dt[:, 0])
    state = state * da[..., None, None] + upd
    yh = torch.einsum("bn,bhpn->bhp", c_mat[:, 0].float(), state)
    yh = yh[:, None] + p["d_skip"][None, None, :, None] * xh.float()
    return yh, state, xp[:, 1:]


def _mamba_masked_step(p: dict, xbc, dt, state_all, conv_all,
                       active: torch.Tensor, cfg: ModelConfig,
                       dtype) -> tuple:
    """The one-token recurrence over the slot array (rows ``[0, S)`` of the
    pool, the null slot excluded), inactive slots keeping their state bit
    for bit: a slot without a running request must not advance."""
    s_slots = active.shape[0]
    state, conv = state_all[:s_slots], conv_all[:s_slots]
    yh, state_new, conv_new = _mamba_step(p, xbc, dt, state, conv, cfg,
                                          dtype)
    state_new = torch.where(active[:, None, None, None], state_new, state)
    conv_new = torch.where(active[:, None, None], conv_new, conv.to(dtype))
    return yh, state_new, conv_new


def _mamba_scan(p: dict, xbc: torch.Tensor, dt: torch.Tensor,
                cfg: ModelConfig, conv_cache, init_state, lengths,
                dtype) -> tuple:
    """Multi-token conv + SSD over a (possibly right-padded) span, carrying
    ``conv_cache`` / ``init_state`` in from an earlier chunk.  ``lengths``
    (b,) masks ``dt`` to zero past each row's valid tokens, so pads never
    advance the recurrence (decay ``exp(0·a) = 1``, update 0), and cuts the
    conv tail at the valid boundary.  Returns ``(yh f32, state, conv
    tail)``."""
    if lengths is not None:
        mask = torch.arange(xbc.shape[1], device=xbc.device)[None, :] < \
            lengths[:, None]
        dt = dt * mask[..., None].to(dt.dtype)
    xbc_c, conv_tail = L.causal_conv1d(xbc, p["conv_w"].to(dtype),
                                       cache=conv_cache, lengths=lengths)
    xh, b_mat, c_mat = _split_xbc(xbc_c, cfg)
    yh, state = L.ssd_chunked(xh, dt, p["a_log"], b_mat, c_mat,
                              init_state=init_state)
    yh = yh.float() + p["d_skip"][None, None, :, None] * xh.float()
    return yh, state, conv_tail


def mamba_block_prefill(p: dict, x: torch.Tensor, cfg: ModelConfig,
                        stamp: Optional[StampConfig],
                        seq_lengths: Optional[torch.Tensor] = None,
                        split: Optional[ModelSplit] = None) -> tuple:
    """Whole sequences from a zero state (the calibration forward, the
    training forward and the bucketed prefill): returns ``(x, {"state",
    "conv"})``, the state after each row's last valid token
    (``seq_lengths``).  Under a model ``split`` the leaves are this rank's
    heads' blocks (:func:`_mixer_blocks`): the conv runs over its
    channels, the SSD over its heads with the whole B and C, and the
    entry is its block (:func:`_ssm_entry`)."""
    z, xbc, dt = _mamba_in(p, x, cfg, stamp, False, split)
    yh, state, conv_tail = _mamba_scan(p, xbc, dt, cfg, None, None,
                                       seq_lengths, x.dtype)
    return (_mamba_out(p, yh, z, x, cfg, stamp, False, split),
            {"state": state, "conv": conv_tail.to(torch.bfloat16)})


def mamba_block_cached_decode(p: dict, x: torch.Tensor, cfg: ModelConfig,
                              entry: dict, dm: bool,
                              split: Optional[ModelSplit] = None
                              ) -> torch.Tensor:
    """One token per row against the contiguous cache; the entry updates
    in place.  Under a model ``split`` as :func:`mamba_block_prefill`:
    the entry is this rank's block."""
    z, xbc, dt = _mamba_in(p, x, cfg, None, dm, split)
    yh, state, conv = _mamba_step(p, xbc, dt, entry["state"],
                                  entry["conv"], cfg, x.dtype)
    entry["state"] = state
    entry["conv"] = conv.to(entry["conv"].dtype)
    return _mamba_out(p, yh, z, x, cfg, None, dm, split)


def mamba_block_decode(p: dict, x: torch.Tensor, cfg: ModelConfig,
                       entry: dict, active: torch.Tensor,
                       dm: bool) -> torch.Tensor:
    """The slot array against the slot-dense pool (inactive slots masked);
    rows ``[0, S)`` update in place."""
    z, xbc, dt = _mamba_in(p, x, cfg, None, dm)
    yh, state, conv = _mamba_masked_step(p, xbc, dt, entry["state"],
                                         entry["conv"], active, cfg,
                                         x.dtype)
    s_slots = active.shape[0]
    entry["state"][:s_slots] = state
    entry["conv"][:s_slots] = conv.to(entry["conv"].dtype)
    return _mamba_out(p, yh, z, x, cfg, None, dm)


def mamba_block_chunk(p: dict, x: torch.Tensor, cfg: ModelConfig,
                      stamp: Optional[StampConfig], entry: dict,
                      paged: dict) -> torch.Tensor:
    """One prefill chunk of one request (the two-call step): the scan
    carries the conv tail and state of the request's slot row across chunk
    boundaries (zeros on its first chunk) and writes the chunk's final
    ones back to that row."""
    z, xbc, dt = _mamba_in(p, x, cfg, stamp, False)
    state_all, conv_all = entry["state"], entry["conv"]
    slot = int(paged["slot"])
    if paged["first"]:
        conv0 = torch.zeros((1, *conv_all.shape[1:]), dtype=x.dtype,
                            device=x.device)
        state0 = torch.zeros((1, *state_all.shape[1:]),
                             dtype=torch.float32, device=x.device)
    else:
        conv0 = conv_all[slot][None].to(x.dtype)
        state0 = state_all[slot][None]
    yh, state_f, conv_tail = _mamba_scan(p, xbc, dt, cfg, conv0, state0,
                                         paged["valid"].reshape(1),
                                         x.dtype)
    state_all[slot] = state_f[0]
    conv_all[slot] = conv_tail[0].to(conv_all.dtype)
    return _mamba_out(p, yh, z, x, cfg, stamp, False)


def mamba_block_unified(p: dict, x: tuple, cfg: ModelConfig,
                        serve: ServeConfig, entry: dict, paged: dict,
                        dm: bool) -> tuple:
    """One Mamba block of the unified ragged step over the slot-dense
    pool: the chunk rows ``(n_pf, C, d)`` run the stateful scan (each
    span's conv tail and state gathered from its slot row, zeros on a
    first chunk, ``dt`` masked past the valid length) under STaMP, the
    decode slots ``(S, 1, d)`` the masked one-token recurrence transform
    free.  Then the two state writes, in the reference's order: the masked
    decode update over rows ``[0, S)``, then each chunk row's final state
    at its slot (dummy rows at the null slot ``S``)."""
    x_pf, x_dec = x
    state_all, conv_all = entry["state"], entry["conv"]
    stamp = serve.stamp
    z_pf, xbc_pf, dt_pf = _mamba_in(p, x_pf, cfg, stamp, dm)
    slots = paged["pf_slots"].long()
    first = paged["pf_first"]
    conv0 = torch.where(first[:, None, None], 0.0,
                        conv_all[slots].to(x_pf.dtype)).to(x_pf.dtype)
    state0 = torch.where(first[:, None, None, None], 0.0, state_all[slots])
    yh_pf, state_f, conv_tail = _mamba_scan(
        p, xbc_pf, dt_pf, cfg, conv0, state0, paged["pf_valid"],
        x_pf.dtype)
    z_dec, xbc_dec, dt_dec = _mamba_in(p, x_dec, cfg, None, dm)
    yh_dec, state_new, conv_new = _mamba_masked_step(
        p, xbc_dec, dt_dec, state_all, conv_all, paged["dec_active"], cfg,
        x_dec.dtype)
    s_slots = x_dec.shape[0]
    state_all[:s_slots] = state_new
    state_all[slots] = state_f
    conv_all[:s_slots] = conv_new.to(conv_all.dtype)
    conv_all[slots] = conv_tail.to(conv_all.dtype)
    return (_mamba_out(p, yh_pf, z_pf, x_pf, cfg, stamp, dm),
            _mamba_out(p, yh_dec, z_dec, x_dec, cfg, None, dm))


# ---------------------------------------------------------------------------
# forward entry points
# ---------------------------------------------------------------------------


def _embed(params: dict, tokens: torch.Tensor,
           split: Optional[ModelSplit] = None) -> torch.Tensor:
    """The token embeddings in bf16.  Under a model ``split``
    (vocab-parallel) ``embed`` is this rank's block of rows: ids outside
    it give zeros, and the ranks' rows are summed (one is not zero)."""
    if split is None:
        return params["embed"][tokens.long()].to(COMPUTE_DTYPE)
    table = params["embed"]
    ids, mine = split.local_ids(tokens, table.shape[0] * split.size)
    return split.reduce_out((table[ids] * mine[..., None]).to(COMPUTE_DTYPE))


def prefill_layer(p: dict, spec: LayerSpec, x: torch.Tensor,
                  cfg: ModelConfig, stamp: Optional[StampConfig] = None,
                  kv: Optional[KV.KVCacheConfig] = None,
                  capacity: Optional[int] = None,
                  enc_out: Optional[torch.Tensor] = None,
                  seq_lengths: Optional[torch.Tensor] = None,
                  split: Optional[ModelSplit] = None,
                  group: Optional[SeqGroup] = None) -> tuple:
    """One layer of the full-sequence forward (the reference's
    ``apply_block`` in ``prefill`` / ``train`` mode): the mixer, its
    cross-attention given the encoder output, and the FFN, under ``stamp``
    when given.  Returns ``(x, cache entry)``: with ``kv`` an attention
    layer's contiguous cache for ``capacity`` tokens (this rank's block
    of it under a sequence ``group``), a Mamba layer's recurrent state
    after each row's ``seq_lengths``.  Under a model ``split`` the
    mixer and the FFN run on this rank's blocks (a Mamba mixer on its
    heads, its state their block)."""
    if spec.mixer == "mamba":
        x, entry = mamba_block_prefill(p, x, cfg, stamp, seq_lengths, split)
    else:
        x, entry = attn_block_prefill(p, x, cfg, stamp, kv, capacity,
                                      enc_out, split, group)
    return ffn_block(p, x, spec, cfg, stamp, False, split), entry


def _recompute(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward (the
    reference's ``jax.checkpoint`` with ``nothing_saveable``): only the
    inputs are kept."""
    from torch.utils.checkpoint import checkpoint
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def final_hidden(params: dict, x: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    return L.rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)


def as_batch(batch) -> dict:
    """A batch dict as the reference's entry points take it; a bare tensor
    is the ``tokens``."""
    return batch if isinstance(batch, dict) else {"tokens": batch}


def encoder_layer(p: dict, x: torch.Tensor, cfg: ModelConfig,
                  split: Optional[ModelSplit] = None) -> torch.Tensor:
    """One encoder layer (the reference's ``_encoder_forward`` body, its
    ``attn_block`` and ``ffn_block`` without STaMP): RoPE'd non-causal
    self-attention and the SwiGLU MLP, each with its residual, no cache.
    The encoder runs unquantized on its (packed) weights, so its linears
    are plain products with f32 sums (:func:`_linear`'s ``f32_sum``).
    Under a model ``split`` (training) each linear is this rank's block,
    as in the decoder's layers."""
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    h = _copy_in(L.rms_norm(x, p["ln1"].to(x.dtype), cfg.norm_eps), split)
    q, k, v = (_linear(h, p[w], p.get(b), f32_sum=True) for w, b in
               (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
    attn = _attention(q, k, v, positions, cfg, False, split)
    x = x + _reduced(_linear(attn, p["wo"], f32_sum=True, split=split),
                     split, x.dtype)
    h = _copy_in(L.rms_norm(x, p["ln2"].to(x.dtype), cfg.norm_eps), split)
    g = silu(_linear(h, p["wi_gate"], f32_sum=True)) * \
        _linear(h, p["wi_up"], f32_sum=True)
    return x + _reduced(_linear(g, p["wo_mlp"], f32_sum=True, split=split),
                        split, x.dtype)


def _placed(v) -> bool:
    """A leaf (or a packed / prepared dict) placed as DTensors."""
    return any(isinstance(t, DTensor) for t in
               (v.values() if isinstance(v, dict) else (v,)))


def _model_whole(k: str, v, split: ModelSplit):
    """A placed mixer leaf gathered over the batch axes, made whole along
    ``model``: ``in_proj``'s blocks gathered (the backward reduce-scatters
    the ranks' gradients: each rank's B and C columns get a part of
    theirs), a replicated leaf passed through a copy-in (its gradient,
    each rank's heads' part, summed over the model ranks once)."""
    if k != "in_proj":
        return split.copy_in(v)
    if isinstance(v, dict):
        return {n: split.gather(t, -1) for n, t in v.items()}
    return split.gather(v, -1)


def _gathered(p, policy: Optional[ShardingPolicy],
              split: Optional[ModelSplit] = None):
    """``p`` (a tree or a leaf) with its sharded leaves gathered whole
    (ZeRO-3's all-gather at use; a no-op without a policy or on whole
    leaves).  Under a model ``split`` a layer's leaves keep their
    ``model`` block; plain tensors there are this rank's blocks already
    (:func:`model_blocks`).  A Mamba mixer placed by the rule table is
    made whole along ``model`` (:func:`_model_whole`: ``in_proj``'s flat
    ``[z, x, B, C, dt]`` columns do not split on head boundaries) and cut
    to this rank's heads (:func:`_mixer_blocks`).  Prepared int8 sites
    placed by the rule table are refused under a split: the table's block
    of a merged ``wqkv`` is not ``[wq | wk | wv]``'s blocks, and a row
    block's column sums are not the whole weight's (prepare them with
    :func:`prepare_fused_weights`'s ``split``)."""
    if policy is None:
        return p
    if split is None:
        return policy.gather(p)
    for k, v in p.items():
        if isinstance(v, dict) and "iq" in v and _placed(v):
            raise ValueError(
                f"{k}: prepared weights under a model split are prepared "
                f"whole and cut to this rank's blocks "
                f"(prepare_fused_weights(..., split=)), not placed by the "
                f"rule table")
    out = {k: policy.gather(v, keep_model=True) for k, v in p.items()}
    if "in_proj" in p and _placed(p["in_proj"]):
        out.update(_mixer_blocks({k: _model_whole(k, out[k], split)
                                  for k in _MIXER}, split))
    return out


def _top(params: dict, policy: Optional[ShardingPolicy],
         split: Optional[ModelSplit] = None) -> dict:
    """``params`` with the leaves outside ``layers`` / ``encoder``
    (``embed``, ``head``, ``final_norm``) gathered, once a step: a tied
    embedding serves the lookup and the head from one copy.  Under a
    model ``split`` the embedding and the head keep their vocabulary
    blocks."""
    if policy is None:
        return params
    return {k: v if k in ("layers", "encoder") else
            policy.gather(v, keep_model=split is not None)
            for k, v in params.items()}


def encoder_forward(params: dict, frames: torch.Tensor,
                    cfg: ModelConfig, remat: bool = False,
                    policy: Optional[ShardingPolicy] = None,
                    split: Optional[ModelSplit] = None) -> torch.Tensor:
    """The encoder over the frame embeddings ``(b, s_enc, d)`` (cast to
    bf16), then its final RMSNorm: the cross-attention's memory.  With
    ``remat`` (training) each layer is recomputed in the backward; under
    a sharding ``policy`` each layer's leaves are gathered inside it (its
    ``model`` blocks kept under a ``split``)."""
    x = frames.to(COMPUTE_DTYPE)
    for p in params["encoder"]["layers"]:
        def layer(a, p=p):
            return encoder_layer(_gathered(p, policy, split), a, cfg, split)
        x = _recompute(layer, x) if remat else layer(x)
        x = constrain(x, policy, lambda pol: pol.acts())
    norm = _gathered(params["encoder"]["final_norm"], policy)
    return L.rms_norm(x, norm.to(x.dtype), cfg.norm_eps)


def embed_inputs(params: dict, batch: dict, cfg: ModelConfig,
                 encoder: bool = True, remat: bool = False,
                 policy: Optional[ShardingPolicy] = None,
                 split: Optional[ModelSplit] = None) -> tuple:
    """The decoder's input and the encoder output, as the reference's
    ``model_hidden`` builds them: an enc-dec (or frames) stack embeds the
    tokens and runs ``frames`` through the encoder; a patch frontend puts
    ``patches`` before the token embeddings; else the token embeddings.
    A batch without the frontend's key raises its ``KeyError``.  Returns
    ``(x, enc_out or None)``; ``encoder=False`` leaves ``enc_out`` None
    for a caller that runs the encoder itself; ``remat`` recomputes its
    layers in the backward; a model ``split`` reaches the embedding and
    the encoder."""
    enc_out = None
    if cfg.frontend == "frames" or cfg.encoder_layers:
        frames = batch["frames"]
        if encoder:
            enc_out = encoder_forward(params, frames, cfg, remat, policy,
                                      split)
        x = _embed(params, batch["tokens"], split)
    elif cfg.frontend == "patch":
        tok = _embed(params, batch["tokens"], split)
        x = torch.cat([batch["patches"].to(COMPUTE_DTYPE).to(tok.device),
                       tok], dim=1)
    else:
        x = _embed(params, batch["tokens"], split)
    return x, enc_out


def model_hidden(params: dict, batch, cfg: ModelConfig,
                 stamp: Optional[StampConfig] = None,
                 kv_cfg: Optional[KV.KVCacheConfig] = None,
                 remat: bool = False,
                 policy: Optional[ShardingPolicy] = None,
                 split: Optional[ModelSplit] = None) -> torch.Tensor:
    """Full-sequence forward through the layer code of :func:`prefill`:
    final normed hidden states ``(b, s, d)`` in bf16 at every position.
    Without ``stamp`` it is the calibration pass and the training forward
    (the reference's ``model_hidden(mode="train")``); with ``stamp`` and
    ``kv_cfg``, the reference's ``mode="prefill"`` hidden states (Table 2's
    perplexity).  ``remat`` (training) recomputes each layer's activations
    in the backward, the reference's scanned body under ``jax.checkpoint``.
    ``batch``: a dict as the reference's (``tokens``, and ``patches`` or
    ``frames``), or the tokens.  Under a sharding ``policy`` (training on
    a mesh) ``batch`` holds this rank's rows, each layer's leaves are
    gathered inside the layer (so a recomputed layer gathers again in the
    backward), and the residual is constrained to ``policy.acts()`` after
    the embedding and after every layer, where the reference constrains
    it.  With a model ``split`` (the training loss's) each layer keeps
    its leaves' ``model`` blocks and computes only them; the residual
    between layers is whole on every model rank."""
    params = _top(params, policy, split)
    x, enc_out = embed_inputs(params, as_batch(batch), cfg, remat=remat,
                              policy=policy, split=split)
    x = constrain(x, policy, lambda pol: pol.acts())
    for spec, p in zip(cfg.layer_specs(), params["layers"]):
        def layer(a, p=p, spec=spec, e=enc_out):
            return prefill_layer(_gathered(p, policy, split), spec, a, cfg,
                                 stamp, kv_cfg, None, e, split=split)[0]
        x = _recompute(layer, x) if remat else layer(x)
        x = constrain(x, policy, lambda pol: pol.acts())
    return final_hidden(params, x, cfg)


def _xent_chunk(xc: torch.Tensor, head, lc: torch.Tensor) -> tuple:
    logits = _linear(xc, head).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.clamp_min(lc, 0).long()[..., None])[..., 0]
    valid = (lc >= 0).float()
    return torch.sum((logz - gold) * valid), torch.sum(valid)


def _xent_chunk_split(xc: torch.Tensor, head, lc: torch.Tensor,
                      split: ModelSplit) -> tuple:
    """:func:`_xent_chunk` vocab-parallel: ``head`` is this rank's
    ``(d, V / size)`` block, so only its logits exist here; the row max
    (all-reduced with ``MAX``, held constant: ``logsumexp``'s gradient
    does not depend on it), the sum of exponentials and the gold logit
    (from the rank whose block holds the label, zeros elsewhere) are
    summed over the model ranks."""
    logits = _linear(xc, head).float()
    m = split.max(logits.amax(dim=-1))
    sumexp = split.reduce_out(torch.exp(logits - m[..., None]).sum(dim=-1))
    logz = torch.log(sumexp) + m
    ids, mine = split.local_ids(lc, logits.shape[-1] * split.size)
    gold = torch.gather(logits, -1, ids[..., None])
    gold = split.reduce_out(gold[..., 0] * mine)
    valid = (lc >= 0).float()
    return torch.sum((logz - gold) * valid), torch.sum(valid)


def chunked_xent(x: torch.Tensor, head, labels: torch.Tensor,
                 chunk: int = 512,
                 policy: Optional[ShardingPolicy] = None,
                 split: Optional[ModelSplit] = None) -> torch.Tensor:
    """Cross-entropy without materializing ``(b, s, vocab)``: sequence
    chunks of ``chunk`` positions, each chunk's f32 logits recomputed in
    the backward (the reference's scan body under ``jax.checkpoint``).
    Labels < 0 are ignored (VLM patch positions).  Under a sharding
    ``policy`` ``x`` and ``labels`` are this rank's rows, and the loss is
    the global batch's: the summed loss and the count of valid labels are
    each summed over the data ranks before the division (a mean of the
    ranks' means would weigh ranks with fewer valid labels more); each
    rank's gradient is that of its own rows' share, summed over the ranks
    where the parameters' gradients meet.  Under a model ``split``
    ``head`` is this rank's vocabulary block and each chunk's loss is
    vocab-parallel (:func:`_xent_chunk_split`): the ``(b, chunk, V)``
    logits never exist whole on a rank."""
    b, s, _ = x.shape
    chunk = min(chunk, s)
    assert s % chunk == 0
    loss = cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    x = _copy_in(x, split)
    fn, extra = (_xent_chunk, ()) if split is None else \
        (_xent_chunk_split, (split,))
    for c0 in range(0, s, chunk):
        lc = labels[:, c0:c0 + chunk].to(x.device)
        part, n = _recompute(fn, x[:, c0:c0 + chunk], head, lc, *extra)
        loss, cnt = loss + part, cnt + n
    if policy is not None:
        loss, cnt = policy.batch_sum(loss), policy.batch_sum(cnt)
    return loss / torch.clamp_min(cnt, 1.0)


def train_loss(params: dict, batch: dict, cfg: ModelConfig,
               policy: Optional[ShardingPolicy] = None) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (``tokens``,
    ``labels``, and ``patches`` or ``frames`` where the arch takes them):
    the training forward without STaMP, each layer recomputed in the
    backward, then :func:`chunked_xent` over the head (``embed.T`` when
    tied).  Under a sharding ``policy`` the parameters are DTensors,
    ``batch`` is this rank's rows, and the loss is the global batch's.
    A policy whose ``model`` axis has more than one rank splits the
    compute along it (:meth:`ShardingPolicy.model_split`): each model
    rank computes its block of the linears, the heads that block
    overlaps, its vocabulary block of the embedding and the loss, its
    experts, and its heads of each Mamba mixer."""
    split = None if policy is None else policy.model_split()
    params = _top(params, policy, split)
    x = model_hidden(params, batch, cfg, remat=True, policy=policy,
                     split=split)
    return chunked_xent(x, _head_weight(params), batch["labels"],
                        policy=policy, split=split)


def _ssm_entry(cfg: ModelConfig, batch: int, device,
               split: Optional[ModelSplit] = None) -> dict:
    """A zero contiguous Mamba cache entry: ``state`` (b, h, p, n) f32 and
    the conv tail (b, width − 1, conv_dim) bf16.  Under a model ``split``
    this rank's block: its heads' state (b, h / model, p, n), the
    reference's placement (``ShardingPolicy.ssm_state``), and its
    channels' conv tail (b, width − 1, d_inner / model + 2n), ``[x block
    | B | C]`` (the reference splits the flat conv_dim instead)."""
    _, conv_dim, h, _ = mixer_widths(cfg, split)
    return {"state": torch.zeros((batch, h, cfg.ssm_head_dim,
                                  cfg.ssm_state), dtype=torch.float32,
                                 device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, conv_dim),
                                dtype=torch.bfloat16, device=device)}


def init_cache(cfg: ModelConfig, batch: int, seq: int, serve: ServeConfig,
               device=None, group: Optional[SeqGroup] = None,
               split: Optional[ModelSplit] = None) -> list:
    """Zero contiguous decode cache, one dict per layer: an attention
    layer's K/V (an enc-dec stack's with the cross-attention's bf16 ``xk``
    / ``xv`` of ``max(seq // frame_ratio, 1)`` positions), a Mamba layer's
    recurrent state.  Under a sequence ``group`` an attention layer's is
    this rank's block of it (:class:`~repro_torch.serving.kvcache.
    SeqBlock`, ``xk`` / ``xv`` too); under a model ``split`` a Mamba
    layer's is its heads' block (:func:`_ssm_entry`)."""
    dev = resolve_device(device)
    hd, kvh = cfg.resolved_head_dim, cfg.num_kv_heads

    def attn_entry():
        entry = KV.init_layer_cache(batch, seq, kvh, hd, serve.kv,
                                    device=dev,
                                    block=KV.seq_block(serve.kv, seq, group))
        if cfg.encoder_layers:
            s_enc = max(seq // cfg.frame_ratio, 1)
            if group is not None:
                s_enc = group.region(s_enc)[1]
            shape = (batch, s_enc, kvh, hd)
            for k in ("xk", "xv"):
                entry[k] = torch.zeros(shape, dtype=torch.bfloat16,
                                       device=dev)
        return entry

    return [_ssm_entry(cfg, batch, dev, split) if spec.mixer == "mamba"
            else attn_entry() for spec in cfg.layer_specs()]


def _serve_split(policy: Optional[ShardingPolicy]) -> Optional[ModelSplit]:
    """The serving steps' model split: the training step's, its
    row-parallel parts summed in f32 and rounded once
    (``ModelSplit.f32_parts``)."""
    split = None if policy is None else policy.model_split()
    return None if split is None else \
        dataclasses.replace(split, f32_parts=True)


def prefill(params: dict, batch, cfg: ModelConfig, serve: ServeConfig,
            last_pos: Optional[torch.Tensor] = None,
            enc_out: Optional[torch.Tensor] = None, *,
            policy: Optional[ShardingPolicy] = None,
            global_batch: Optional[int] = None) -> tuple:
    """Whole-prompt forward with STaMP activation quantization: next-token
    logits ``(b, V)`` f32 read at ``last_pos`` (b,) per row (default: the
    last column; right-padded prompts read their true last token), and
    the contiguous mixed-precision cache (one dict per layer) sized
    ``serve.cache_capacity``; with quant telemetry collected, also the
    site stats.  ``batch``: the tokens, or a dict as the reference's
    (``tokens`` with ``patches`` — put before the tokens, so positions
    and ``last_pos`` count them — or ``frames`` for the encoder; a given
    ``enc_out``, the encoder's output for those frames, is taken as it is
    and the encoder does not run).  Mamba layers stop their recurrence at
    each row's ``last_pos``: attention never reads a right pad (causal),
    but a recurrent state would keep absorbing them.  Under a sharding
    ``policy`` (the reference's argument) the parameters are DTensors
    placed by its rules (or, under a model split, plain tensors holding
    this rank's blocks: :func:`model_blocks`, :func:`prepare_fused_weights`
    with its ``split``), ``batch`` holds this rank's rows (the batch axes'
    split of the global batch; all of it where ``global_batch`` is below
    the batch axes' size, as the reference replicates it), each layer's
    leaves are gathered inside the layer and the residual is constrained
    to ``policy.acts()``, as in :func:`model_hidden`; the logits are this
    rank's rows.  A policy whose ``model`` axis has more than one rank
    splits the compute along it (:meth:`ShardingPolicy.model_split`, as
    the training loss does): each rank computes its blocks of the
    linears (STaMP's row statistics all-reduced at row-parallel sites),
    the heads its block overlaps, its experts, the encoder's and the
    cross-attention's blocks and its vocabulary block of the logits
    (gathered whole on every model rank), and its heads of each Mamba
    mixer (:func:`mamba_block_prefill`).  An attention layer's cache is
    this rank's block of the sequence over
    :meth:`ShardingPolicy.seq_group` (the reference's placement), a Mamba
    layer's its heads' state and channels' conv tail
    (:func:`_ssm_entry`)."""
    batch = as_batch(batch)
    dev = batch["tokens"].device
    seq_lengths = None if last_pos is None else \
        last_pos.to(dev).to(torch.int32) + 1
    split = _serve_split(policy)
    group = None if policy is None else policy.seq_group(global_batch)
    params = _top(params, policy, split)

    def stack():
        x, enc = embed_inputs(params, batch, cfg, encoder=enc_out is None,
                              policy=policy, split=split)
        enc = enc_out if enc is None else enc
        x = constrain(x, policy, lambda pol: pol.acts())
        cache = []
        for spec, p in zip(cfg.layer_specs(), params["layers"]):
            x, entry = prefill_layer(_gathered(p, policy, split), spec, x,
                                     cfg, serve.stamp, serve.kv,
                                     serve.cache_capacity, enc, seq_lengths,
                                     split, group)
            x = constrain(x, policy, lambda pol: pol.acts())
            cache.append(entry)
        return x, cache

    collect = _collect_telemetry(serve)
    (x, cache), telem = _with_telemetry(collect, stack)
    if last_pos is None:
        x_last = x[:, -1]
    else:
        rows = torch.arange(x.shape[0], device=x.device)
        x_last = x[rows, last_pos.to(x.device).long()]
    logits = _logits(params, x_last, cfg, split)
    return (logits, cache, telem) if collect else (logits, cache)


def decode_step(params: dict, cache: list, tokens: torch.Tensor, pos,
                cfg: ModelConfig, serve: ServeConfig, *,
                policy: Optional[ShardingPolicy] = None,
                global_batch: Optional[int] = None) -> tuple:
    """One token per slot against the contiguous cache.  ``tokens``: (b,);
    ``pos``: a scalar (every slot at the same length) or (b,) per-slot
    positions, where each new token's K/V is written.  Decode runs
    transform free; with ``fused_decode_matmul`` its linears over prepared
    weights take the decode kernel K3.  The cache updates in place (an
    enc-dec entry's ``xk`` / ``xv`` are carried: the reference's decode
    runs no cross-attention).  Returns ``(logits (b, V) f32, cache)``.
    Under a sharding ``policy`` the parameters are placed as for
    :func:`prefill`; ``tokens`` and ``cache`` are this rank's rows (all
    of them where ``global_batch`` is below the batch axes' size), the
    cache this rank's block of the sequence over
    :meth:`ShardingPolicy.seq_group` — the reference's
    ``policy.decode_kv_spec``: each rank attends over its block and the
    partial softmax states are merged in rank order
    (:func:`attn_block_cached_decode`; ``serve.cache_capacity`` must
    give the whole cache's length); a Mamba layer's entry is this rank's
    heads' block (:func:`init_cache` with the ``split``).  A ``model``
    axis of more than one rank splits the compute as in :func:`prefill`
    (decode's row-parallel linears over prepared weights take K3's row
    statistics all-reduced and its int32 parts summed over the ranks
    before one epilogue: :func:`_row_linear`);
    the logits are gathered whole on every model rank, so the greedy
    token is the same on all of them."""
    dm = serve.fused_decode_matmul
    split = _serve_split(policy)
    group = None if policy is None else policy.seq_group(global_batch)
    params = _top(params, policy, split)
    x = _embed(params, tokens[:, None], split)
    pos = torch.as_tensor(pos, device=x.device).to(torch.int32)
    for spec, p, entry in zip(cfg.layer_specs(), params["layers"], cache):
        p = _gathered(p, policy, split)
        if spec.mixer == "mamba":
            x = mamba_block_cached_decode(p, x, cfg, entry, dm, split)
        else:
            x = attn_block_cached_decode(p, x, cfg, serve, entry, pos, dm,
                                         split, group)
        x = ffn_block(p, x, spec, cfg, None, dm, split)
    return _logits(params, x[:, 0], cfg, split), cache


def refuse_paged(cfg: ModelConfig) -> None:
    """Raise for an encoder-decoder stack, which paged serving does not
    cover (the reference's refusal in ``init_paged_cache``)."""
    if cfg.encoder_layers:
        raise NotImplementedError(
            "paged serving does not cover encoder-decoder stacks: the "
            "cross-attention K/V is computed once from the encoder output "
            "and held dense per request — serve these through "
            "BucketedEngine (--engine bucketed)")


def init_paged_cache(cfg: ModelConfig, pcfg: PKV.PagedCacheConfig,
                     device=None, num_slots: Optional[int] = None) -> list:
    """Zero cache state, one dict per layer: page pools for an attention
    layer (block ids are shared across layers: one allocation covers the
    whole stack), and for a Mamba layer the slot-dense state of
    ``num_slots`` slots (the engine's decode slots) plus the null slot.
    An encoder-decoder stack raises ``NotImplementedError``
    (:func:`refuse_paged`)."""
    refuse_paged(cfg)
    dev = resolve_device(device)
    specs = cfg.layer_specs()
    if any(s.mixer == "mamba" for s in specs) and num_slots is None:
        raise ValueError(
            "hybrid/SSM stacks hold slot-dense SSM state: init_paged_cache "
            "needs num_slots (the engine's max_slots) to size the per-slot "
            "state pool")
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return [PKV.init_ssm_slots(num_slots, cfg.conv_width, conv_dim,
                               cfg.ssm_heads, cfg.ssm_head_dim,
                               cfg.ssm_state, device=dev)
            if spec.mixer == "mamba"
            else PKV.init_pools(cfg.num_kv_heads, cfg.resolved_head_dim,
                                pcfg, device=dev) for spec in specs]


def _logits(params: dict, x: torch.Tensor, cfg: ModelConfig,
            split: Optional[ModelSplit] = None):
    """f32 logits over the vocabulary; under a model ``split`` the head is
    this rank's vocabulary block and its logits are gathered whole."""
    y = _linear(final_hidden(params, x, cfg), _head_weight(params)).float()
    return y if split is None else split.gather(y, -1)


def paged_decode_step(params: dict, pools: list, tokens: torch.Tensor,
                      positions: torch.Tensor, hi_table: torch.Tensor,
                      lo_table: torch.Tensor, pages: torch.Tensor,
                      offsets: torch.Tensor, is_hi: torch.Tensor,
                      cfg: ModelConfig, serve: ServeConfig,
                      active: Optional[torch.Tensor] = None) -> tuple:
    """One decode step for the whole slot array (also the unified step's
    all-decode case).  ``tokens`` / ``positions``: (S,); ``pages /
    offsets / is_hi``: (S,) write targets (inactive slots → null page);
    ``active``: (S,) bool, the slots whose Mamba state may advance (default
    all: a Mamba recurrence has no null page to hide a pad behind).  The
    pools update in place.  Returns ``(logits (S, V), pools)``."""
    dm = serve.fused_decode_matmul
    x = _embed(params, tokens[:, None])
    if active is None:
        active = torch.ones(tokens.shape, dtype=torch.bool,
                            device=tokens.device)
    paged = {"dec_ht": hi_table, "dec_lt": lo_table,
             "dec_positions": positions, "dec_lengths": positions + 1,
             "pages": pages, "offsets": offsets, "is_hi": is_hi}
    for spec, p, entry in zip(cfg.layer_specs(), params["layers"], pools):
        if spec.mixer == "mamba":
            x = mamba_block_decode(p, x, cfg, entry, active, dm)
        else:
            x = attn_block_decode(p, x, cfg, serve, entry, paged, dm)
        x = ffn_block(p, x, spec, cfg, None, dm)
    return _logits(params, x[:, 0], cfg), pools


def paged_prefill_chunk(params: dict, pools: list, tokens: torch.Tensor,
                        start, hi_table: torch.Tensor,
                        lo_table: torch.Tensor, pages: torch.Tensor,
                        offsets: torch.Tensor, is_hi: torch.Tensor,
                        last_index, cfg: ModelConfig,
                        serve: ServeConfig, first: bool = True,
                        slot: Optional[int] = None) -> tuple:
    """One prefill chunk of one request into the paged cache: the prefill
    half of the two-call step (``step_mode="two_call"``), the reference's
    ``paged_prefill_chunk``.

    ``tokens``: (1, C) right-padded chunk; ``start``: tokens already cached
    (earlier chunks, a swap-in or a prefix hit); ``hi_table / lo_table``:
    (1, ·) the request's block tables; ``pages / offsets / is_hi``: (C,)
    write targets (pads → null page); ``last_index``: the chunk-local row
    whose logits are the next-token distribution.  The linears run under
    STaMP (the fused kernels K1 → K2 over prepared weights, never the
    decode matmul); the attention is the plain chunked attention of
    :func:`attn_block_chunk`.  Mamba layers carry their state across
    chunks through the request's ``slot`` row of the state pool (zeros
    when ``first``), over the chunk's ``last_index + 1`` valid tokens.
    The pools update in place.  Returns ``(logits (1, V), pools)``, plus
    the quant-telemetry site stats when collected."""
    c = tokens.shape[1]
    dev = tokens.device
    start = torch.as_tensor(start, device=dev).reshape(1).to(torch.int32)
    li = torch.as_tensor(last_index, device=dev).reshape(1)
    if slot is None and any(s.mixer == "mamba" for s in cfg.layer_specs()):
        raise ValueError("a Mamba layer's chunk needs the request's slot")
    paged = {"positions": start[:, None] + torch.arange(c, device=dev),
             "start": start, "hi_table": hi_table, "lo_table": lo_table,
             "pages": pages, "offsets": offsets, "is_hi": is_hi,
             "first": first, "slot": slot, "valid": li + 1}

    def stack():
        x = _embed(params, tokens)
        for spec, p, entry in zip(cfg.layer_specs(), params["layers"],
                                  pools):
            if spec.mixer == "mamba":
                x = mamba_block_chunk(p, x, cfg, serve.stamp, entry, paged)
            else:
                x = attn_block_chunk(p, x, cfg, serve, entry, paged)
            x = ffn_block(p, x, spec, cfg, serve.stamp, False)
        return x

    collect = _collect_telemetry(serve)
    x, telem = _with_telemetry(collect, stack)
    logits = _logits(params, x[0, li.long()], cfg)
    return (logits, pools, telem) if collect else (logits, pools)


def paged_unified_step(params: dict, pools: list, pf_tokens: torch.Tensor,
                       pf_start: torch.Tensor, pf_length: torch.Tensor,
                       pf_last_index: torch.Tensor, dec_tokens: torch.Tensor,
                       dec_positions: torch.Tensor, hi_table: torch.Tensor,
                       lo_table: torch.Tensor, pages: torch.Tensor,
                       offsets: torch.Tensor, is_hi: torch.Tensor,
                       cfg: ModelConfig, serve: ServeConfig,
                       pf_first: Optional[torch.Tensor] = None,
                       pf_slots: Optional[torch.Tensor] = None,
                       dec_active: Optional[torch.Tensor] = None) -> tuple:
    """ONE forward per engine step: ``n_pf`` prefill chunk spans (rows of
    ``pf_tokens`` (n_pf, C), right-padded) and the decode slot array.

    ``pf_start`` / ``pf_length``: (n_pf,) tokens cached before / after the
    chunk; ``pf_last_index``: (n_pf,) chunk-local row whose logits are the
    next-token distribution; ``dec_tokens / dec_positions``: (S,);
    ``hi_table / lo_table``: (n_pf + S, ·) span-ordered block tables;
    ``pages / offsets / is_hi``: (n_pf·C + S,) write targets.  Mamba
    layers read ``pf_first`` (n_pf,) bool (the chunk starts its request:
    zero state), ``pf_slots`` (n_pf,) the chunk's slot row (dummy rows: the
    null slot S) and ``dec_active`` (S,) bool (slots whose state may
    advance; default all).  ``n_pf = 0`` runs :func:`paged_decode_step`.  The pools update in place.
    Returns ``(pf_logits (n_pf, V), dec_logits (S, V), pools)``, plus the
    quant-telemetry site stats when collected (empty on an all-decode step:
    decode runs transform free)."""
    n_pf, c_len = pf_tokens.shape
    collect = _collect_telemetry(serve)
    if dec_active is None:
        dec_active = torch.ones(dec_tokens.shape, dtype=torch.bool,
                                device=dec_tokens.device)
    if n_pf == 0:
        dec_logits, pools = paged_decode_step(
            params, pools, dec_tokens, dec_positions, hi_table, lo_table,
            pages, offsets, is_hi, cfg, serve, dec_active)
        out = (dec_logits.new_zeros((0, dec_logits.shape[-1])), dec_logits,
               pools)
        return out + ({},) if collect else out
    # chunk rows of width 1 would alias decode shapes: keep them on the
    # transform path
    dm = serve.fused_decode_matmul and c_len > 1
    x_pf = _embed(params, pf_tokens)
    x_dec = _embed(params, dec_tokens[:, None])
    ar = torch.arange(c_len, device=pf_tokens.device)
    paged = {"span_ht": hi_table, "span_lt": lo_table,
             "span_starts": torch.cat([pf_start, dec_positions]),
             "span_lengths": torch.cat([pf_length, dec_positions + 1]),
             "pf_ht": hi_table[:n_pf], "pf_lt": lo_table[:n_pf],
             "dec_ht": hi_table[n_pf:], "dec_lt": lo_table[n_pf:],
             "pf_positions": pf_start[:, None] + ar[None, :],
             "pf_start": pf_start, "dec_positions": dec_positions,
             "dec_lengths": dec_positions + 1,
             "pages": pages, "offsets": offsets, "is_hi": is_hi,
             "pf_first": pf_first, "pf_slots": pf_slots,
             "pf_valid": pf_length - pf_start, "dec_active": dec_active}

    def stack():
        x = (x_pf, x_dec)
        for spec, p, entry in zip(cfg.layer_specs(), params["layers"],
                                  pools):
            if spec.mixer == "mamba":
                x = mamba_block_unified(p, x, cfg, serve, entry, paged, dm)
            else:
                x = attn_block_unified(p, x, cfg, serve, entry, paged, dm)
            x = (ffn_block(p, x[0], spec, cfg, serve.stamp, dm),
                 ffn_block(p, x[1], spec, cfg, None, dm))
        return x

    (x_pf, x_dec), telem = _with_telemetry(collect, stack)
    rows = torch.arange(n_pf, device=x_pf.device)
    pf_logits = _logits(params, x_pf[rows, pf_last_index.long()], cfg)
    out = (pf_logits, _logits(params, x_dec[:, 0], cfg), pools)
    return out + (telem,) if collect else out

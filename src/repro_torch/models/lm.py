"""Dense GQA and MoE decoders: calibration forward, the paged serving
steps (the unified step; the two-call pair ``paged_prefill_chunk`` /
``paged_decode_step``), and the contiguous-cache ``prefill`` /
``decode_step`` of the bucketed engine (the port of those paths of
``repro.models.lm``).  With ``ServeConfig.quant_telemetry`` the prefill
entry points also return the per-site quant-health stats
(`repro_torch.obs.quantstats`); ``fused_site_matrix`` is the per-site
fused / reference audit the engines publish.

Parameters are a plain dict of tensors: ``embed``, ``final_norm``,
``head`` (absent when tied) and ``layers`` — one dict per layer (the
reference's prologue and scanned ``period`` stack unrolled; each layer's
``LayerSpec`` comes from ``cfg.layer_specs()``).  Stored f32 or bf16 and
cast to bf16 at use; serving params hold packed-int4 or prepared-int8 dicts
for the large matmuls.  MoE layers hold the router ``gate_w`` and the
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

from repro_torch.core.stamp import (StampConfig, fused_eligible,
                                    fused_ineligibility, prepare_linear,
                                    stamp_fake_quant)
from repro_torch.core.quant import EPS, fdiv
from repro_torch.device import resolve_device
from repro_torch.kernels.cache_attention import cache_decode_attention
from repro_torch.kernels.decode_matmul import stamp_decode_matmul
from repro_torch.kernels.paged_attention import (paged_decode_attention,
                                                 paged_ragged_attention)
from repro_torch.kernels.stamp_matmul import down_slab_sums, silu
from repro_torch.models import layers as L
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.obs import quantstats as QS
from repro_torch.serving import kvcache as KV
from repro_torch.serving import paged_kvcache as PKV

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
    f32), and a bf16 stack equals the f32 one cast."""
    out = torch.empty((e, din, dout), dtype=dtype, device=device)
    for i in range(e):
        out[i] = _dense(gen, din, dout, device, dtype)
    return out


def _init_layer(cfg: ModelConfig, spec: LayerSpec, gen, dev, dtype) -> dict:
    d = cfg.d_model

    def ones(n):
        return torch.ones(n, device=dev, dtype=dtype)

    p = {"ln1": ones(d),
         "wq": _dense(gen, d, cfg.q_dim, dev, dtype),
         "wk": _dense(gen, d, cfg.kv_dim, dev, dtype),
         "wv": _dense(gen, d, cfg.kv_dim, dev, dtype),
         "wo": _dense(gen, cfg.q_dim, d, dev, dtype)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(cfg.q_dim, device=dev, dtype=dtype)
        p["bk"] = torch.zeros(cfg.kv_dim, device=dev, dtype=dtype)
        p["bv"] = torch.zeros(cfg.kv_dim, device=dev, dtype=dtype)
    p["ln2"] = ones(d)
    if spec.ffn in ("mlp", "moe_dense"):
        pre = "d" if spec.ffn == "moe_dense" else ""
        p[f"{pre}wi_gate"] = _dense(gen, d, cfg.d_ff, dev, dtype)
        p[f"{pre}wi_up"] = _dense(gen, d, cfg.d_ff, dev, dtype)
        p[f"{pre}wo_mlp"] = _dense(gen, cfg.d_ff, d, dev, dtype)
    if spec.ffn in ("moe", "moe_dense"):
        e, f = cfg.num_experts, cfg.expert_d_ff
        # the router stays in f32 whatever ``dtype`` is (d x E, small): it
        # routes on f32 weights, as the reference's does
        p["gate_w"] = _dense(gen, d, e, dev, torch.float32)
        p["we_gate"] = _expert_stack(gen, e, d, f, dev, dtype)
        p["we_up"] = _expert_stack(gen, e, d, f, dev, dtype)
        p["we_down"] = _expert_stack(gen, e, f, d, dev, dtype)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                dtype=torch.float32, lazy: bool = False) -> dict:
    """Random parameters from ``seed`` (a ``torch.Generator`` on the
    target device), with the reference's shapes and scales, drawn in f32
    and stored in ``dtype`` (a bf16 model equals the f32 one cast; MoE
    routers stay f32).  With
    ``lazy``, ``layers`` is an iterator that draws each layer when it is
    reached, with the same numbers: a full-width MoE stack is set up one
    layer at a time.  Runs on ``cuda`` unless ``device`` says otherwise."""
    dev = resolve_device(device)
    specs = cfg.layer_specs()
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
    layers = (_init_layer(cfg, spec, gen, dev, dtype) for spec in specs)
    params["layers"] = layers if lazy else list(layers)
    return params


def from_jax_params(tree: dict, cfg: ModelConfig, device="cpu") -> dict:
    """The reference's ``init_params`` pytree, given as numpy arrays, as
    the port's params: the prologue layers, then the stacked ``period``
    axis unrolled into ``layers`` (expert leaves keep their ``(E, ·, ·)``
    stack); ``head`` is kept when present (tied models read ``embed.T`` at
    use, as the reference's ``_head_weight`` does)."""
    pro, period, nper = cfg.layer_plan()

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    params = {k: t(tree[k]) for k in ("embed", "final_norm", "head")
              if k in tree}
    params["layers"] = [{k: t(v) for k, v in tree["prologue"][i].items()}
                        for i in range(len(pro))]
    params["layers"] += [
        {k: t(np.asarray(v)[i]) for k, v in tree["period"][j].items()}
        for i in range(nper) for j in range(len(period))]
    return params


def _head_weight(params: dict) -> torch.Tensor:
    return params["head"] if "head" in params else params["embed"].T


def fused_site_matrix(cfg: ModelConfig, stamp: Optional[StampConfig]
                      ) -> dict:
    """Eligibility audit: every STaMP site this architecture instantiates,
    mapped to ``fused`` or ``reference`` with reason codes (the
    reference's ``lm.fused_site_matrix``).  Cells: ``{"status", "kernel",
    "wiring", "layers", "reasons"}`` keyed by the telemetry site label
    (``qkv`` / ``wo`` / ``gate_up`` / ``wo_mlp`` / ``moe``)."""
    base = (("stamp_disabled",) if stamp is None
            else fused_ineligibility(stamp))
    matrix: dict = {}

    def add(site, kernel, wiring):
        cell = matrix.setdefault(site, {
            "status": "fused" if not base else "reference",
            "kernel": kernel if not base else None,
            "wiring": wiring, "layers": 0, "reasons": list(base)})
        cell["layers"] += 1

    for spec in cfg.layer_specs():
        if spec.mixer == "attn":
            add("qkv", "stamp_quant_matmul", "merged_wqkv")
            add("wo", "stamp_quant_matmul", "single_head_merge")
        if spec.ffn in ("mlp", "moe_dense"):
            add("gate_up", "stamp_quant_dual_matmul", "pair")
            add("wo_mlp", "stamp_quant_matmul", "single")
        if spec.ffn in ("moe", "moe_dense"):
            add("moe", "stamp_quant_grouped_matmul", "grouped_dispatch")
    return matrix


# ---------------------------------------------------------------------------
# (possibly quantized) linears and weight preparation
# ---------------------------------------------------------------------------


def _dequant_packed(w: dict, dtype) -> torch.Tensor:
    q = KV.unpack_nibbles(w["q"].transpose(-1, -2)).to(dtype)
    q = q.transpose(-1, -2)                                  # (din, dout)
    return (q - w["zp"].to(dtype)) * w["scale"].to(dtype)


def _linear(x: torch.Tensor, w, b=None,
            decode_matmul: bool = False) -> torch.Tensor:
    """Matmul over a plain tensor, a packed-int4 dict ``{"q", "scale",
    "zp"}`` or a prepared int8 dict ``{"iq", "isw", "izw", "iqsum"}``.  With
    ``decode_matmul``, decode-shaped input (one token per slot) over
    prepared weights runs the decode kernel on the int8 codes."""
    if isinstance(w, dict) and "iq" in w:
        if decode_matmul and x.ndim >= 2 and x.shape[-2] == 1:
            lead = x.shape[:-1]
            y = stamp_decode_matmul(x.reshape(-1, x.shape[-1]), w["iq"],
                                    w["isw"], w["izw"], w["iqsum"], b,
                                    out_dtype=x.dtype)
            return y.reshape(*lead, y.shape[-1])
        # codes and zero points are small integers: exact in bf16
        wd = (w["iq"].to(x.dtype) - w["izw"].to(x.dtype)) * \
            w["isw"].to(x.dtype)
    elif isinstance(w, dict):
        wd = _dequant_packed(w, x.dtype)
    else:
        wd = w.to(x.dtype)
    y = x @ wd
    return y + b.to(x.dtype) if b is not None else y


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


_BIG = ("wq", "wk", "wv", "wo", "wi_gate", "wi_up", "wo_mlp", "dwi_gate",
        "dwi_up", "dwo_mlp", "we_gate", "we_up", "we_down")
_EXPERTS = ("we_gate", "we_up", "we_down")


def _one_expert(w, e: int):
    return {k: v[e] for k, v in w.items()} if isinstance(w, dict) else w[e]


def _per_expert(fn, w) -> dict:
    """``fn`` (a ``(din, dout)`` weight or packed dict → dict of tensors)
    over a stacked ``(E, ·, ·)`` weight one expert at a time, stacked into
    preallocated outputs: its f32 temporaries stay one expert's size."""
    first = fn(_one_expert(w, 0))
    n = (next(iter(w.values())) if isinstance(w, dict) else w).shape[0]
    out = {k: v.new_empty((n, *v.shape)) for k, v in first.items()}
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


def prepare_fused_weights(params: dict, stamp: StampConfig) -> dict:
    """Hoist every fused site's weights into int8 buffers ``{"iq", "isw",
    "izw", "iqsum"}``, one layer at a time: wq/wk/wv merge into ``wqkv``
    (biases into ``bqkv``), gate/up and the out-projections prepare per
    site, expert stacks one expert at a time (``we_down`` also keeps its
    per-slab sums ``iqslab``).  Packed int4 weights are dequantized and
    re-coded at ``stamp.fused_weight_bits``.  ``params["layers"]`` may be
    an iterator: a layer handed over that way is dropped as soon as it is
    prepared.  No-op when the config cannot run the fused kernels."""
    if not fused_eligible(stamp):
        return params
    bits = stamp.fused_weight_bits
    layers = []
    for p in params["layers"]:
        out = {k: v for k, v in p.items()
               if k not in _BIG and k not in ("bq", "bk", "bv")}
        raws = [_dequant_packed(p[k], torch.float32)
                if isinstance(p[k], dict) else p[k].float()
                for k in ("wq", "wk", "wv")]
        out["wqkv"] = _prep(torch.cat(raws, dim=-1), bits)
        del raws
        if all(k in p for k in ("bq", "bk", "bv")):
            out["bqkv"] = torch.cat([p["bq"], p["bk"], p["bv"]], dim=-1)
        for k in ("wo", "wi_gate", "wi_up", "wo_mlp", "dwi_gate", "dwi_up",
                  "dwo_mlp"):
            if k in p:
                out[k] = _prep(p[k], bits)
        for k in _EXPERTS:
            if k in p:
                fn = _prep_down_expert if k == "we_down" else _prep
                out[k] = _per_expert(lambda w: fn(w, bits), p[k])
        layers.append(out)
    return {**{k: v for k, v in params.items() if k != "layers"},
            "layers": layers}


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _maybe_stamp(x: torch.Tensor, stamp: Optional[StampConfig],
                 site: Optional[str] = None):
    if stamp is None or not stamp.enabled:
        return x
    return stamp_fake_quant(x, stamp, site=site)


def _split_heads(x: torch.Tensor, nh: int, hd: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], nh, hd)


def _rope(flat, positions, cfg: ModelConfig, nh: int, hd: int):
    return L.apply_rope(_split_heads(flat, nh, hd), positions,
                        cfg.rope_theta)


def _attn_qkv(p: dict, h: torch.Tensor, cfg: ModelConfig,
              stamp: Optional[StampConfig], dm: bool) -> tuple:
    """QKV projections (shared by every path)."""
    if "wqkv" in p:
        bqkv = p.get("bqkv")
        if _use_fused(stamp, p["wqkv"]):
            qkv = L.stamp_fused_linear(h, p["wqkv"], bqkv, stamp,
                                       site="qkv")
        else:
            qkv = _linear(_maybe_stamp(h, stamp, "qkv"), p["wqkv"], bqkv,
                          dm)
        return torch.split(qkv, [cfg.q_dim, cfg.kv_dim, cfg.kv_dim], dim=-1)
    h = _maybe_stamp(h, stamp, "qkv")
    return (_linear(h, p["wq"], p.get("bq"), dm),
            _linear(h, p["wk"], p.get("bk"), dm),
            _linear(h, p["wv"], p.get("bv"), dm))


def _attn_out(p: dict, attn: torch.Tensor, x: torch.Tensor,
              stamp: Optional[StampConfig], dm: bool) -> torch.Tensor:
    """Out-projection of the head-split attention output + residual."""
    if _use_fused(stamp, p["wo"]):
        return x + L.stamp_fused_linear(attn, p["wo"], None, stamp,
                                        merge_heads=True, site="wo")
    out = _maybe_stamp(attn.reshape(*attn.shape[:-2], -1), stamp, "wo")
    return x + _linear(out, p["wo"], None, dm)


class _ExpertStack:
    """Expert ``e``'s ``(din, dout)`` weight of a stacked prepared-int8 or
    packed-int4 expert dict, dequantized in ``dtype`` when indexed — the
    reference's ``_expert_w`` one expert at a time (a whole Arctic stack in
    bf16 is 8.9 GB)."""

    def __init__(self, w, dtype):
        self.w, self.dtype = w, dtype

    def __getitem__(self, e: int) -> torch.Tensor:
        w, dt = _one_expert(self.w, e), self.dtype
        if isinstance(w, dict) and "iq" in w:
            # codes and zero points are integers in [-128, 127]: exact in
            # bf16
            return (w["iq"].to(dt) - w["izw"].to(dt)) * w["isw"].to(dt)
        if isinstance(w, dict):
            return _dequant_packed(w, dt)
        return w.to(dt)


def ffn_block(p: dict, x: torch.Tensor, spec: LayerSpec, cfg: ModelConfig,
              stamp: Optional[StampConfig], dm: bool) -> torch.Tensor:
    """SwiGLU MLP and/or MoE + residual, summed as the reference does: ``x
    + ((0 + moe) + mlp)``.  The fused MLP is one dual call for gate/up and
    one call for the down-projection; the fused MoE routes on the stamped
    round trip and runs the expert stack through the grouped kernel.
    Without fused weights or STaMP (the decode region, calibration) the
    MoE runs the reference FFN over the routed experts only."""
    h = L.rms_norm(x, p["ln2"].to(x.dtype), cfg.norm_eps)
    hq = None
    out = torch.zeros_like(x)
    if spec.ffn in ("moe", "moe_dense"):
        hq = _maybe_stamp(h, stamp, "moe")
        route = (cfg.experts_per_token, cfg.capacity_factor,
                 cfg.moe_group_size)
        if all(_use_fused(stamp, p[k]) for k in _EXPERTS):
            out = out + L.moe_ffn_fused(hq, p["gate_w"], p["we_gate"],
                                        p["we_up"], p["we_down"], *route)
        else:
            out = out + L.moe_ffn(hq, p["gate_w"], *(
                _ExpertStack(p[k], x.dtype) for k in _EXPERTS), *route)
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
                                             site="wo_mlp")
        else:
            out = out + _linear(_maybe_stamp(g, stamp, "wo_mlp"), wo, None,
                                dm)
    return x + out


def attn_block_prefill(p: dict, x: torch.Tensor, cfg: ModelConfig,
                       stamp: Optional[StampConfig],
                       kv: Optional[KV.KVCacheConfig] = None,
                       capacity: Optional[int] = None) -> tuple:
    """Causal self-attention over whole sequences: QKV (the fused STaMP
    linear over prepared weights, or the reference path), RoPE, attention,
    out-projection.  With ``kv`` it also returns the layer's contiguous
    cache, quantized from the RoPE'd K and V with room for ``capacity``
    tokens (the bucketed engine's prefill); without, ``None`` (the
    calibration forward)."""
    hd, nh, kvh = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    h = L.rms_norm(x, p["ln1"].to(x.dtype), cfg.norm_eps)
    q, k, v = _attn_qkv(p, h, cfg, stamp, False)
    q = _rope(q, positions, cfg, nh, hd)
    k = _rope(k, positions, cfg, kvh, hd)
    v = _split_heads(v, kvh, hd)
    attn = L.flash_attention(q, k, v, causal=True)
    entry = None if kv is None else KV.quantize_full(k, v, kv,
                                                     capacity=capacity)
    return _attn_out(p, attn, x, stamp, False), entry


def attn_block_cached_decode(p: dict, x: torch.Tensor, cfg: ModelConfig,
                             serve: ServeConfig, entry: dict,
                             pos: torch.Tensor, dm: bool) -> torch.Tensor:
    """One token per slot against the contiguous cache: write the token's
    K/V at ``pos`` (scalar or (b,)), then attend over ``pos + 1`` tokens —
    through the packed-cache attention kernel K6 when
    ``fused_cache_attention`` is set, else over the dequantized hi and lo
    segments (or the dense bf16 cache)."""
    hd, nh, kvh = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    kv = serve.kv
    positions = pos[:, None] if pos.ndim == 1 else pos.reshape(1, 1)
    h = L.rms_norm(x, p["ln1"].to(x.dtype), cfg.norm_eps)
    q, k, v = _attn_qkv(p, h, cfg, None, dm)
    q = _rope(q, positions, cfg, nh, hd)
    k = _rope(k, positions, cfg, kvh, hd)
    KV.write_token(entry, k, _split_heads(v, kvh, hd), pos, kv)
    length = (pos.reshape(-1) + 1).to(torch.int32).expand(x.shape[0])
    if kv.quantized and serve.fused_cache_attention:
        attn = cache_decode_attention(entry, q, length)
    elif kv.quantized:
        (k_hi, v_hi), (k_lo, v_lo) = KV.dequantize_segments(entry, x.dtype)
        attn = L.decode_attention_segments(
            q, [(k_hi, v_hi, 0), (k_lo, v_lo, k_hi.shape[1])], length=length)
    else:
        kf, vf = KV.dequantize_full(entry, kv, x.dtype)
        attn = L.decode_attention(q, kf, vf, length=length)
    return _attn_out(p, attn, x, None, dm)


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
# forward entry points
# ---------------------------------------------------------------------------


def _embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()].to(COMPUTE_DTYPE)


def hidden_layer(p: dict, spec: LayerSpec, x: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """One layer of the full-sequence forward without STaMP."""
    x, _ = attn_block_prefill(p, x, cfg, None)
    return ffn_block(p, x, spec, cfg, None, False)


def final_hidden(params: dict, x: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    return L.rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)


def model_hidden(params: dict, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence forward without STaMP (the calibration pass): final
    normed hidden states ``(b, s, d)`` in bf16."""
    x = _embed(params, tokens)
    for spec, p in zip(cfg.layer_specs(), params["layers"]):
        x = hidden_layer(p, spec, x, cfg)
    return final_hidden(params, x, cfg)


def _attention_layers_only(cfg: ModelConfig) -> None:
    if any(spec.mixer != "attn" for spec in cfg.layer_specs()):
        raise NotImplementedError("the port's caches hold attention layers "
                                  "only (no Mamba state yet)")


def init_cache(cfg: ModelConfig, batch: int, seq: int, serve: ServeConfig,
               device=None) -> list:
    """Zero contiguous decode cache, one dict per attention layer."""
    _attention_layers_only(cfg)
    dev = resolve_device(device)
    return [KV.init_layer_cache(batch, seq, cfg.num_kv_heads,
                                cfg.resolved_head_dim, serve.kv, device=dev)
            for _ in range(cfg.num_layers)]


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            serve: ServeConfig,
            last_pos: Optional[torch.Tensor] = None) -> tuple:
    """Whole-prompt forward with STaMP activation quantization: next-token
    logits ``(b, V)`` f32 read at ``last_pos`` (b,) per row (default: the
    last column; right-padded prompts read their true last token), and
    the contiguous mixed-precision cache (one dict per layer) sized
    ``serve.cache_capacity``; with quant telemetry collected, also the
    site stats."""
    _attention_layers_only(cfg)

    def stack():
        x = _embed(params, tokens)
        cache = []
        for spec, p in zip(cfg.layer_specs(), params["layers"]):
            x, entry = attn_block_prefill(p, x, cfg, serve.stamp, serve.kv,
                                          serve.cache_capacity)
            x = ffn_block(p, x, spec, cfg, serve.stamp, False)
            cache.append(entry)
        return x, cache

    collect = _collect_telemetry(serve)
    (x, cache), telem = _with_telemetry(collect, stack)
    if last_pos is None:
        x_last = x[:, -1]
    else:
        rows = torch.arange(x.shape[0], device=x.device)
        x_last = x[rows, last_pos.to(x.device).long()]
    logits = _logits(params, x_last, cfg)
    return (logits, cache, telem) if collect else (logits, cache)


def decode_step(params: dict, cache: list, tokens: torch.Tensor, pos,
                cfg: ModelConfig, serve: ServeConfig) -> tuple:
    """One token per slot against the contiguous cache.  ``tokens``: (b,);
    ``pos``: a scalar (every slot at the same length) or (b,) per-slot
    positions, where each new token's K/V is written.  Decode runs
    transform free; with ``fused_decode_matmul`` its linears over prepared
    weights take the decode kernel K3.  The cache updates in place.
    Returns ``(logits (b, V) f32, cache)``."""
    dm = serve.fused_decode_matmul
    x = _embed(params, tokens[:, None])
    pos = torch.as_tensor(pos, device=x.device).to(torch.int32)
    for spec, p, entry in zip(cfg.layer_specs(), params["layers"], cache):
        x = attn_block_cached_decode(p, x, cfg, serve, entry, pos, dm)
        x = ffn_block(p, x, spec, cfg, None, dm)
    return _logits(params, x[:, 0], cfg), cache


def init_paged_cache(cfg: ModelConfig, pcfg: PKV.PagedCacheConfig,
                     device=None) -> list:
    """Zero page pools, one dict per attention layer (block ids are shared
    across layers: one allocation covers the whole stack)."""
    dev = resolve_device(device)
    return [PKV.init_pools(cfg.num_kv_heads, cfg.resolved_head_dim, pcfg,
                           device=dev) for _ in range(cfg.num_layers)]


def _logits(params: dict, x: torch.Tensor, cfg: ModelConfig):
    return _linear(final_hidden(params, x, cfg), _head_weight(params)).float()


def paged_decode_step(params: dict, pools: list, tokens: torch.Tensor,
                      positions: torch.Tensor, hi_table: torch.Tensor,
                      lo_table: torch.Tensor, pages: torch.Tensor,
                      offsets: torch.Tensor, is_hi: torch.Tensor,
                      cfg: ModelConfig, serve: ServeConfig) -> tuple:
    """One decode step for the whole slot array (also the unified step's
    all-decode case).  ``tokens`` / ``positions``: (S,); ``pages /
    offsets / is_hi``: (S,) write targets (inactive slots → null page).
    The pools update in place.  Returns ``(logits (S, V), pools)``."""
    dm = serve.fused_decode_matmul
    x = _embed(params, tokens[:, None])
    paged = {"dec_ht": hi_table, "dec_lt": lo_table,
             "dec_positions": positions, "dec_lengths": positions + 1,
             "pages": pages, "offsets": offsets, "is_hi": is_hi}
    for spec, p, entry in zip(cfg.layer_specs(), params["layers"], pools):
        x = attn_block_decode(p, x, cfg, serve, entry, paged, dm)
        x = ffn_block(p, x, spec, cfg, None, dm)
    return _logits(params, x[:, 0], cfg), pools


def paged_prefill_chunk(params: dict, pools: list, tokens: torch.Tensor,
                        start, hi_table: torch.Tensor,
                        lo_table: torch.Tensor, pages: torch.Tensor,
                        offsets: torch.Tensor, is_hi: torch.Tensor,
                        last_index, cfg: ModelConfig,
                        serve: ServeConfig) -> tuple:
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
    :func:`attn_block_chunk`.  The pools update in place.  Returns
    ``(logits (1, V), pools)``, plus the quant-telemetry site stats when
    collected."""
    _attention_layers_only(cfg)
    c = tokens.shape[1]
    dev = tokens.device
    start = torch.as_tensor(start, device=dev).reshape(1).to(torch.int32)
    paged = {"positions": start[:, None] + torch.arange(c, device=dev),
             "start": start, "hi_table": hi_table, "lo_table": lo_table,
             "pages": pages, "offsets": offsets, "is_hi": is_hi}

    def stack():
        x = _embed(params, tokens)
        for spec, p, entry in zip(cfg.layer_specs(), params["layers"],
                                  pools):
            x = attn_block_chunk(p, x, cfg, serve, entry, paged)
            x = ffn_block(p, x, spec, cfg, serve.stamp, False)
        return x

    collect = _collect_telemetry(serve)
    x, telem = _with_telemetry(collect, stack)
    li = torch.as_tensor(last_index, device=dev).reshape(1).long()
    logits = _logits(params, x[0, li], cfg)
    return (logits, pools, telem) if collect else (logits, pools)


def paged_unified_step(params: dict, pools: list, pf_tokens: torch.Tensor,
                       pf_start: torch.Tensor, pf_length: torch.Tensor,
                       pf_last_index: torch.Tensor, dec_tokens: torch.Tensor,
                       dec_positions: torch.Tensor, hi_table: torch.Tensor,
                       lo_table: torch.Tensor, pages: torch.Tensor,
                       offsets: torch.Tensor, is_hi: torch.Tensor,
                       cfg: ModelConfig, serve: ServeConfig) -> tuple:
    """ONE forward per engine step: ``n_pf`` prefill chunk spans (rows of
    ``pf_tokens`` (n_pf, C), right-padded) and the decode slot array.

    ``pf_start`` / ``pf_length``: (n_pf,) tokens cached before / after the
    chunk; ``pf_last_index``: (n_pf,) chunk-local row whose logits are the
    next-token distribution; ``dec_tokens / dec_positions``: (S,);
    ``hi_table / lo_table``: (n_pf + S, ·) span-ordered block tables;
    ``pages / offsets / is_hi``: (n_pf·C + S,) write targets.  ``n_pf =
    0`` runs :func:`paged_decode_step`.  The pools update in place.
    Returns ``(pf_logits (n_pf, V), dec_logits (S, V), pools)``, plus the
    quant-telemetry site stats when collected (empty on an all-decode step:
    decode runs transform free)."""
    n_pf, c_len = pf_tokens.shape
    collect = _collect_telemetry(serve)
    if n_pf == 0:
        dec_logits, pools = paged_decode_step(
            params, pools, dec_tokens, dec_positions, hi_table, lo_table,
            pages, offsets, is_hi, cfg, serve)
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
             "pages": pages, "offsets": offsets, "is_hi": is_hi}

    def stack():
        x = (x_pf, x_dec)
        for spec, p, entry in zip(cfg.layer_specs(), params["layers"],
                                  pools):
            x = attn_block_unified(p, x, cfg, serve, entry, paged, dm)
            x = (ffn_block(p, x[0], spec, cfg, serve.stamp, dm),
                 ffn_block(p, x[1], spec, cfg, None, dm))
        return x

    (x_pf, x_dec), telem = _with_telemetry(collect, stack)
    rows = torch.arange(n_pf, device=x_pf.device)
    pf_logits = _logits(params, x_pf[rows, pf_last_index.long()], cfg)
    out = (pf_logits, _logits(params, x_dec[:, 0], cfg), pools)
    return out + (telem,) if collect else out

"""Model building blocks (the port of the dense and MoE pieces of
``repro.models.layers``): RMSNorm, RoPE, the plain attention variants, the
fused STaMP linear sites and capacity-routed MoE (routing, the reference
expert FFN and the grouped-kernel one)."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.stamp import (PreparedLinear, stamp_dual_linear,
                                    stamp_linear, token_quantize)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.stamp_matmul import silu
from repro_torch.obs import quantstats as QS


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """f32 statistics, scaling in ``x``'s dtype (as the reference)."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * gamma


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                            / head_dim)).astype(np.float32)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., s, h, hd); positions broadcastable to (..., s)."""
    hd = x.shape[-1]
    freqs = torch.from_numpy(rope_frequencies(hd, theta)).to(x.device)
    angles = positions[..., None].float() * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# fused STaMP linear sites (integer deployment path)
# ---------------------------------------------------------------------------


def _prepared(w: dict, b=None) -> PreparedLinear:
    return PreparedLinear(qw=w["iq"], sw=w["isw"], zw=w["izw"],
                          qw_sum=w["iqsum"], bias=b)


def stamp_fused_linear(x: torch.Tensor, w: dict, b: Optional[torch.Tensor],
                       stamp_cfg, merge_heads: bool = False,
                       site: Optional[str] = None) -> torch.Tensor:
    """One STaMP linear over prepared int8 buffers ``{"iq", "isw",
    "izw", "iqsum"}``; ``merge_heads`` marks the raw head-split out-proj
    input; ``site`` names the quant-telemetry site."""
    return stamp_linear(x, None, None, stamp_cfg, prepared=_prepared(w, b),
                        merge_heads=merge_heads, site=site)


def stamp_fused_dual_linear(x: torch.Tensor, w_gate: dict, w_up: dict,
                            stamp_cfg, site: Optional[str] = None
                            ) -> torch.Tensor:
    """SwiGLU front half through one shared quantize and the dual GEMM."""
    return stamp_dual_linear(x, None, None, stamp_cfg,
                             prepared_gate=_prepared(w_gate),
                             prepared_up=_prepared(w_up), site=site)


# ---------------------------------------------------------------------------
# MoE (routing is plain PyTorch, as it is XLA in the reference)
# ---------------------------------------------------------------------------


def _moe_fold(x: torch.Tensor, group_size: int) -> tuple:
    """Fold ``(bsz, seq, d)`` into routing groups ``(b, gs, d)`` with the
    pad-tail validity mask (pad tokens must not take expert slots)."""
    bsz, seq, d = x.shape
    gs = min(group_size, seq)
    pad = -seq % gs
    if pad:
        x = torch.cat([x, x.new_zeros((bsz, pad, d))], dim=1)
    seq_p = seq + pad
    x = x.reshape(bsz * (seq_p // gs), gs, d)
    valid = (torch.arange(seq_p, device=x.device) < seq).float()
    valid = valid[None].expand(bsz, seq_p).reshape(x.shape[0], gs)
    return x, valid, seq_p


def moe_route(x: torch.Tensor, gate_w: torch.Tensor, experts_per_token: int,
              capacity_factor: float, valid: torch.Tensor) -> tuple:
    """GShard capacity routing, shared by the reference and fused MoE
    paths: f32 logits and softmax, top-k (lower index first on ties),
    renormalised gates, f32 cumsum capacity positions (top-1 choices
    first).  Returns ``(combine (b, s, E, C) in x.dtype, dispatch, counts
    (b, E) int32)``; each bucket's kept slots are a prefix of ``[0, C)``.
    With a quant-telemetry scope open, the per-expert load and drop
    counters are recorded under the ``moe_router`` pseudo-site."""
    b, s, _ = x.shape
    e = gate_w.shape[-1]
    k = experts_per_token
    cap = max(int(np.ceil(s * k / e * capacity_factor)), 1)
    probs = torch.softmax(x.float() @ gate_w.float(), dim=-1)   # (b, s, E)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = order.values[..., :k], order.indices[..., :k]
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    onehot = torch.nn.functional.one_hot(gate_idx, e).float()  # (b,s,k,E)
    onehot = onehot * valid[:, :, None, None]
    flat = onehot.transpose(1, 2).reshape(b, k * s, e)
    pos = torch.cumsum(flat, dim=1) - flat
    pos = pos.reshape(b, k, s, e).transpose(1, 2)              # (b,s,k,E)
    keep = (pos < cap).float() * onehot
    pos_cap = torch.einsum("bske,bske->bsk", pos, keep)
    cap_onehot = torch.nn.functional.one_hot(pos_cap.long(), cap).float()
    combine = torch.einsum("bsk,bske,bskc->bsec", gate_vals, keep,
                           cap_onehot).to(x.dtype)
    dispatch = (combine > 0).to(x.dtype)
    counts = keep.sum(dim=(1, 2)).to(torch.int32)
    if QS.active():
        QS.record_extra("moe_router", {
            "expert_tokens": keep.sum(dim=(0, 1, 2)),           # (E,)
            "dropped_tokens": onehot.sum() - keep.sum(),
            "capacity_slots": torch.tensor(float(b * e * cap),
                                           device=x.device)})
    return combine, dispatch, counts


def moe_ffn(x: torch.Tensor, gate_w: torch.Tensor, w_gate, w_up, w_down,
            experts_per_token: int, capacity_factor: float,
            group_size: int = 1024) -> torch.Tensor:
    """Capacity-based top-k MoE, reference path.  ``w_gate / w_up``
    index to expert ``e``'s ``(d, f)`` weight by ``w[e]`` and ``w_down``
    to its ``(f, d)`` one (stacked tensors, or a view that dequantizes one
    expert at a time).  Only experts that keep a token are computed: an
    expert without tokens sees all-zero dispatch rows and adds exact zeros
    in the reference's dense einsums, so the sum is unchanged."""
    bsz, seq, d = x.shape
    xg, valid, seq_p = _moe_fold(x, group_size)
    combine, dispatch, counts = moe_route(xg, gate_w, experts_per_token,
                                          capacity_factor, valid)
    xin = torch.einsum("bsec,bsd->becd", dispatch, xg)        # (b, E, C, d)
    out = torch.zeros_like(xin)
    for ei in torch.nonzero(counts.sum(dim=0) > 0).flatten().tolist():
        xe = xin[:, ei]
        h = silu(xe @ w_gate[ei].to(x.dtype)) * (xe @ w_up[ei].to(x.dtype))
        out[:, ei] = h @ w_down[ei].to(x.dtype)
    y = torch.einsum("bsec,becd->bsd", combine, out)
    return y.reshape(bsz, seq_p, d)[:, :seq]


def moe_ffn_fused(x: torch.Tensor, gate_w: torch.Tensor, w_gate: dict,
                  w_up: dict, w_down: dict, experts_per_token: int,
                  capacity_factor: float,
                  group_size: int = 1024) -> torch.Tensor:
    """Capacity MoE through the grouped kernel K5: route on the same
    (stamped) activation as the reference path, quantize each token ONCE
    (:func:`token_quantize`), gather the int8 codes into the capacity
    buckets and run the gate/up/down expert stack over the prepared
    buffers ``{"iq", "isw", "izw", "iqsum"}`` (``we_down`` also carries
    its per-slab sums ``"iqslab"``)."""
    bsz, seq, d = x.shape
    xg, valid, seq_p = _moe_fold(x, group_size)
    combine, dispatch, counts = moe_route(xg, gate_w, experts_per_token,
                                          capacity_factor, valid)
    b, _, e, cap = combine.shape
    qd, sd, zd = token_quantize(xg)
    # slot c of expert e holds the c-th kept token in sequence order, so
    # the argmax over the one-hot sequence axis is the gather index; empty
    # slots gather token 0 and the kernel writes them as zeros
    idx = dispatch.argmax(dim=1).reshape(b, e * cap, 1)

    def gather(t):
        return torch.gather(t, 1, idx.expand(-1, -1, t.shape[-1])
                            ).reshape(b, e, cap, -1)

    ye = kops.stamp_quant_grouped_matmul(
        gather(qd), gather(sd), gather(zd), counts,
        w_gate["iq"], w_gate["isw"], w_gate["izw"], w_gate["iqsum"],
        w_up["iq"], w_up["isw"], w_up["izw"], w_up["iqsum"],
        w_down["iq"], w_down["isw"], w_down["izw"], w_down["iqslab"])
    y = torch.einsum("bsec,becd->bsd", combine, ye.to(x.dtype))
    return y.reshape(bsz, seq_p, d)[:, :seq]


# ---------------------------------------------------------------------------
# attention (plain PyTorch, as the reference's are plain jnp)
# ---------------------------------------------------------------------------


ATTN_CHUNK = 2048     # the reference's ``AttnChunks`` (query and KV)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """GQA attention in f32.  q: (b, sq, h, hd); k/v: (b, skv, g, hd).  A
    sequence that fits one ``ATTN_CHUNK`` takes one masked softmax per row
    (what the reference's online softmax computes over a single chunk);
    longer ones walk ``ATTN_CHUNK``-token query and KV chunks with the
    reference's running ``(m, l, acc)`` recurrence, in its order."""
    b, sq, h, hd = q.shape
    skv, g = k.shape[1], k.shape[2]
    rep = h // g
    qg = q.reshape(b, sq, g, rep, hd).float() * (1.0 / np.sqrt(hd))
    if sq <= ATTN_CHUNK and skv <= ATTN_CHUNK:
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float())
        if causal:
            mask = torch.arange(sq, device=q.device)[:, None] >= \
                torch.arange(skv, device=q.device)[None, :]
            s = torch.where(mask, s, -1e30)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        o = torch.einsum("bgrqk,bkgd->bgrqd", p, v.float())
        o = o / torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
        return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)
    cq, ckv = min(ATTN_CHUNK, sq), min(ATTN_CHUNK, skv)
    if sq % cq or skv % ckv:
        raise ValueError(f"sequence lengths ({sq}, {skv}) must be multiples "
                         f"of the {ATTN_CHUNK}-token attention chunk")
    outs = []
    for qi in range(sq // cq):
        qc = qg[:, qi * cq:(qi + 1) * cq]
        m = qc.new_full((b, g, rep, cq), -1e30)
        l = qc.new_zeros((b, g, rep, cq))
        acc = qc.new_zeros((b, g, rep, cq, hd))
        for ki in range(skv // ckv):
            kc = k[:, ki * ckv:(ki + 1) * ckv].float()
            vc = v[:, ki * ckv:(ki + 1) * ckv].float()
            s = torch.einsum("bqgrd,bkgd->bgrqk", qc, kc)
            if causal:
                qpos = qi * cq + torch.arange(cq, device=q.device)
                kpos = ki * ckv + torch.arange(ckv, device=q.device)
                s = torch.where(qpos[:, None] >= kpos[None, :], s, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bgrqk,bkgd->bgrqd", p, vc)
            m = m_new
        outs.append((acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype))
    o = torch.cat(outs, dim=3)                        # (b, g, rep, sq, hd)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)


def _merge_parts(parts: list) -> tuple:
    m_tot = parts[0][0]
    for m, _, _ in parts[1:]:
        m_tot = torch.maximum(m_tot, m)
    l_tot = torch.zeros_like(m_tot)
    o_tot = torch.zeros_like(parts[0][2])
    for m, l, o in parts:
        corr = torch.exp(m - m_tot)
        l_tot = l_tot + l * corr
        o_tot = o_tot + o * corr[..., None]
    return o_tot, l_tot


def decode_attention_segments(q: torch.Tensor, segments: list,
                              length: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Decode attention over disjoint cache segments ``[(k, v, offset)]``
    merged at the score level; bf16 operands with f32 products and sums (the
    reference's ``preferred_element_type=f32``)."""
    b, _, h, hd = q.shape
    g = segments[0][0].shape[2]
    rep = h // g
    dt = segments[0][0].dtype
    qg = (q.reshape(b, g, rep, hd) * (1.0 / math.sqrt(hd))).to(dt).float()
    parts = []
    for k_seg, v_seg, offset in segments:
        sc = torch.einsum("bgrd,bsgd->bgrs", qg, k_seg.float())
        if length is not None:
            pos = offset + torch.arange(k_seg.shape[1], device=q.device)
            sc = torch.where(pos[None, None, None, :] <
                             length[:, None, None, None], sc, -1e30)
        m = sc.amax(dim=-1)
        p = torch.exp(sc - m[..., None])
        o = torch.einsum("bgrs,bsgd->bgrd", p.to(dt).float(), v_seg.float())
        parts.append((m, p.sum(dim=-1), o))
    o_tot, l_tot = _merge_parts(parts)
    out = o_tot / torch.clamp_min(l_tot, 1e-30)[..., None]
    return out.reshape(b, 1, h, hd).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     length: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-token attention over a dense (b, s, kv, hd) cache: the
    segment attention with one segment (the reference's oracle)."""
    return decode_attention_segments(q, [(k_cache, v_cache, 0)],
                                     length=length)


def chunked_prefill_attention(q: torch.Tensor, segments: list,
                              k_self: torch.Tensor, v_self: torch.Tensor,
                              start: torch.Tensor) -> torch.Tensor:
    """A prefill chunk at positions ``start + i`` attends to the cached
    prefix (dequantized segments, ``kpos < start``) and causally to its own
    raw K/V, merged by online softmax; ``start`` is (b,) per chunk row."""
    b, c, h, hd = q.shape
    g = k_self.shape[2]
    rep = h // g
    qg = q.reshape(b, c, g, rep, hd).float() * (1.0 / math.sqrt(hd))
    start = start.to(torch.int32).reshape(-1).expand(b)
    ar = torch.arange(c, device=q.device)
    qpos = start[:, None] + ar[None, :]
    parts = []

    def score_part(k_seg, v_seg, mask):        # mask: (b, c, s_seg)
        sc = torch.einsum("bcgrd,bsgd->bgrcs", qg, k_seg.float())
        sc = torch.where(mask[:, None, None], sc, -1e30)
        m = sc.amax(dim=-1)
        p = torch.exp(sc - m[..., None])
        o = torch.einsum("bgrcs,bsgd->bgrcd", p, v_seg.float())
        parts.append((m, p.sum(dim=-1), o))

    for k_seg, v_seg, offset in segments:
        kpos = offset + torch.arange(k_seg.shape[1], device=q.device)
        score_part(k_seg, v_seg, (kpos[None, None, :] <
                                  start[:, None, None]).expand(
                                      b, c, k_seg.shape[1]))
    kpos_self = start[:, None] + torch.arange(k_self.shape[1],
                                              device=q.device)
    score_part(k_self, v_self, kpos_self[:, None, :] <= qpos[:, :, None])
    o_tot, l_tot = _merge_parts(parts)
    out = o_tot / torch.clamp_min(l_tot, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, c, h, hd).to(q.dtype)

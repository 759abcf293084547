"""Unfused oracles of the port's kernels — the counterparts of
``repro.kernels.ref``: each runs the reference execution path as separate
PyTorch ops (float fake-quant and dequantized weights for the linears, a
dense direct softmax for attention, a dequantized float matmul for the
standalone int8 GEMM).  The kernels' plain versions, beside them in their
modules, repeat the kernels' own arithmetic instead.  The exceptions are
:func:`cache_decode_attention_ref`, both the plain version of the
packed-cache attention kernel K6 (the Pallas kernel's own order of
operations) and the oracle the CPU tests hold to that kernel, and
``quant_pack_ref``, K8's plain version (the reference's oracle and kernel
share one expression)."""

from __future__ import annotations

import math

import torch

from repro_torch.core import quant as Q
from repro_torch.core import transforms as T
from repro_torch.kernels.decode_matmul import row_quantize8
from repro_torch.kernels.quant_pack import quant_pack_plain
from repro_torch.kernels.stamp_matmul import grouped_block_f, silu
from repro_torch.serving import kvcache as KV


def _fake_quant_transformed(x, transform, levels, skip_first, num_hi,
                            hi_bits, lo_bits):
    if x.ndim == 4:
        x = x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    tx = T.sequence_transform(x.float(), transform, axis=-2, levels=levels,
                              skip_first=skip_first)
    bits = Q.mixed_precision_bits(tx.shape[-2], num_hi, hi_bits, lo_bits,
                                  device=x.device)
    return Q.fake_quant(tx, bits, axis=-1)


def _dequant_w(qw, sw, zw):
    return (qw.float() - zw) * sw


def stamp_quant_matmul_ref(x, qw, sw, zw, bias=None, *, transform="dwt",
                           levels=3, skip_first=True, num_hi=64, hi_bits=8,
                           lo_bits=4, out_dtype=torch.float32):
    """transform → mixed-precision fake quant → dequantized matmul →
    inverse transform → bias."""
    tq = _fake_quant_transformed(x, transform, levels, skip_first, num_hi,
                                 hi_bits, lo_bits)
    y = T.inverse_sequence_transform(tq @ _dequant_w(qw, sw, zw), transform,
                                     axis=-2, levels=levels,
                                     skip_first=skip_first)
    if bias is not None:
        y = y + bias.reshape(1, -1).float()
    return y.to(out_dtype)


def stamp_quant_dual_matmul_ref(x, qw_g, sw_g, zw_g, qw_u, sw_u, zw_u,
                                bias_g=None, bias_u=None, *, transform="dwt",
                                levels=3, skip_first=True, num_hi=64,
                                hi_bits=8, lo_bits=4,
                                out_dtype=torch.float32):
    """ONE shared fake quant, two dequantized matmuls, per-output inverse
    transforms, then ``silu(g)·u`` in the token domain."""
    tq = _fake_quant_transformed(x, transform, levels, skip_first, num_hi,
                                 hi_bits, lo_bits)

    def one(qw, sw, zw, bias):
        y = T.inverse_sequence_transform(tq @ _dequant_w(qw, sw, zw),
                                         transform, axis=-2, levels=levels,
                                         skip_first=skip_first)
        return y if bias is None else y + bias.reshape(1, -1).float()

    g = one(qw_g, sw_g, zw_g, bias_g)
    u = one(qw_u, sw_u, zw_u, bias_u)
    return (silu(g) * u).to(out_dtype)


def stamp_decode_matmul_ref(x, qw, sw, zw, bias=None,
                            out_dtype=torch.float32):
    """Per-row 8-bit fake quant, then a dequantized-weight matmul."""
    q, sx, zx = row_quantize8(x)
    xq = (q.float() - zx[:, None]) * sx[:, None]
    y = xq @ _dequant_w(qw, sw, zw)
    if bias is not None:
        y = y + bias.reshape(1, -1).float()
    return y.to(out_dtype)


def stamp_quant_grouped_matmul_ref(qx, sx, zx, counts, qw_gate, sw_gate,
                                   zw_gate, qw_up, sw_up, zw_up, qw_down,
                                   sw_down, zw_down, *, block_f=512,
                                   out_dtype=torch.float32):
    """Dense oracle of the grouped MoE FFN: dequantize the dispatch buffer
    and the stacked expert weights, gate/up einsums + ``silu·mul``, then the
    down-projection per ``block_f`` slab with the same per-row 8-bit
    requantize (one row scale per slab); slots at or past each bucket's
    count are zeroed."""
    b, e, cap, d = qx.shape
    f = qw_gate.shape[-1]
    x = (qx.float() - zx) * sx                                # (b, E, C, d)
    g = torch.einsum("becd,edf->becf", x, _dequant_w(qw_gate, sw_gate,
                                                      zw_gate))
    u = torch.einsum("becd,edf->becf", x, _dequant_w(qw_up, sw_up, zw_up))
    a = silu(g) * u
    wd = _dequant_w(qw_down, sw_down, zw_down)                # (E, f, d)
    bf = grouped_block_f(block_f, f)
    out = torch.zeros((b, e, cap, d), dtype=torch.float32, device=qx.device)
    for j in range(f // bf):
        blk = a[..., j * bf:(j + 1) * bf]
        mn = blk.amin(dim=-1, keepdim=True)
        mx = blk.amax(dim=-1, keepdim=True)
        sa = torch.clamp_min(Q.div_const(mx - mn, 255.0), Q.EPS)
        za = torch.round(-mn / sa)
        qa = torch.clamp(torch.round(blk / sa) + za, 0.0, 255.0) - za
        out = out + torch.einsum("becf,efd->becd", qa * sa,
                                 wd[:, j * bf:(j + 1) * bf])
    slot = torch.arange(cap, device=qx.device)[None, None, :, None]
    out = torch.where(slot < counts[:, :, None, None], out, 0.0)
    return out.to(out_dtype)


def span_kv(entry: dict, row_hi: torch.Tensor, row_lo: torch.Tensor):
    """Dequantized (n_tok, g, hd) f32 K and V of one span's mapped pages,
    hi region then lo region."""
    pair = []
    for name in ("k", "v"):
        parts = []
        for region, row in (("hi", row_hi), ("lo", row_lo)):
            if row.shape[0] == 0:
                continue
            codes = entry[f"{name}_{region}"][row.long()].flatten(0, 1)
            sc = entry[f"{name}_{region}_scale"][row.long()].flatten(0, 1)
            zp = entry[f"{name}_{region}_zp"][row.long()].flatten(0, 1)
            vals = codes.float() if region == "hi" \
                else KV.unpack_nibbles(codes)
            parts.append(KV.dequant_tokens(vals, sc, zp, torch.float32))
        pair.append(torch.cat(parts, dim=0))
    return pair


def _attend(q_rows, qpos, kd, vd, length):
    """Direct masked softmax of (r, h, hd) query rows at positions ``qpos``
    against (n_tok, g, hd) keys/values."""
    r, h, hd = q_rows.shape
    g = kd.shape[1]
    kv_pos = torch.arange(kd.shape[0], device=kd.device)
    qg = q_rows.reshape(r, g, h // g, hd).float() * (1.0 / math.sqrt(hd))
    sc = torch.einsum("rgpd,sgd->rgps", qg, kd)
    mask = (kv_pos[None, :] <= qpos[:, None]) & (kv_pos[None, :] < length)
    sc = torch.where(mask[:, None, None], sc, -1e30)
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    o = torch.einsum("rgps,sgd->rgpd", p, vd)
    l = p.sum(dim=-1, keepdim=True)
    return (o / torch.clamp_min(l, 1e-30)).reshape(r, h, hd)


def paged_ragged_attention_ref(entry, q_pf, q_dec, q_starts, lengths,
                               hi_table, lo_table) -> tuple:
    """Dense oracle of the unified step's attention: densify each span's
    pages and take one direct masked softmax per query row (``kv_pos <=
    q_pos AND kv_pos < length``).  ``n_pf`` may be 0."""
    n_pf, c_len = q_pf.shape[:2]
    starts, lens = q_starts.tolist(), lengths.tolist()
    outs_pf = []
    for i in range(n_pf):
        kd, vd = span_kv(entry, hi_table[i], lo_table[i])
        qpos = starts[i] + torch.arange(c_len, device=q_pf.device)
        outs_pf.append(_attend(q_pf[i], qpos, kd, vd, lens[i]))
    outs_dec = []
    for j in range(q_dec.shape[0]):
        i = n_pf + j
        kd, vd = span_kv(entry, hi_table[i], lo_table[i])
        qpos = torch.tensor([lens[i] - 1], device=q_dec.device)
        outs_dec.append(_attend(q_dec[j], qpos, kd, vd, lens[i]))
    out_pf = torch.stack(outs_pf).to(q_pf.dtype) if outs_pf else q_pf
    return out_pf, torch.stack(outs_dec).to(q_dec.dtype)


def paged_attention_ref(entry, q, lengths, hi_table, lo_table):
    """Decode-only oracle: the ragged oracle with no prefill spans."""
    q_pf = q.new_empty((0, 1, *q.shape[2:]))
    return paged_ragged_attention_ref(entry, q_pf, q, lengths - 1, lengths,
                                      hi_table, lo_table)[1]


def cache_block_size(block_s: int, s_lo: int) -> int:
    """The Pallas kernel's lo block: ``min(block_s, s_lo)`` halved until it
    divides ``s_lo``."""
    bs = min(block_s, s_lo)
    while s_lo % bs:
        bs //= 2
    return max(bs, 1)


def cache_decode_attention_ref(entry: dict, q: torch.Tensor,
                               length: torch.Tensor,
                               block_s: int = 2048) -> torch.Tensor:
    """Plain version of K6: decode attention over one layer's contiguous
    packed cache, in the order of operations of the Pallas kernel
    (``repro/kernels/cache_attention.py``).  Per (batch row, kv head): q in
    f32 times ``1/√hd``; the lo region in blocks of
    :func:`cache_block_size`, each block's scores masked to ``-1e30`` at
    ``pos >= length``, its max, ``exp``, sums and ``p @ v``; block 0
    merged with the dequantized int8 hi region, later blocks by the online
    merge ``l·c_prev + l_blk·c_blk``; then ``o / max(l, 1e-30)`` in q's
    dtype.  ``q``: (b, 1, h, hd); ``length``: (b,) or (1,) int32."""
    b, _, h, hd = q.shape
    hi_len, g = entry["k_hi"].shape[1], entry["k_hi"].shape[2]
    rep = h // g
    s_lo = entry["k_lo"].shape[1]
    bs = cache_block_size(block_s, s_lo)
    length = length.to(q.device).reshape(-1).expand(b)[:, None, None, None]
    qg = q.reshape(b, g, rep, hd).float() * (1.0 / math.sqrt(hd))

    def region(name, lo, start, stop):
        """Dequantized f32 (b, g, n, hd) tokens [start, stop) of a region;
        scale/zp at the tokens' absolute positions."""
        codes = entry[f"{name}_{'lo' if lo else 'hi'}"][:, start:stop]
        vals = KV.unpack_nibbles(codes) if lo else codes.float()
        off = hi_len if lo else 0
        sc = entry[f"{name}_scale"][:, off + start:off + stop].float()
        zp = entry[f"{name}_zp"][:, off + start:off + stop].float()
        return ((vals - zp[..., None]) * sc[..., None]).transpose(1, 2)

    def scores(k, start):
        s = qg @ k.transpose(-1, -2)                       # (b, g, rep, n)
        pos = start + torch.arange(k.shape[2], device=q.device)
        return torch.where(pos < length, s, -1e30)

    m = l = o = None
    for blk in range(s_lo // bs):
        s = scores(region("k", True, blk * bs, (blk + 1) * bs),
                   hi_len + blk * bs)
        m_blk = s.amax(dim=-1)
        p = torch.exp(s - m_blk[..., None])
        l_blk = p.sum(dim=-1)
        o_blk = p @ region("v", True, blk * bs, (blk + 1) * bs)
        if blk == 0:
            s_hi = scores(region("k", False, 0, hi_len), 0)
            m = torch.maximum(s_hi.amax(dim=-1), m_blk)
            p_hi = torch.exp(s_hi - m[..., None])
            corr = torch.exp(m_blk - m)
            l = p_hi.sum(dim=-1) + l_blk * corr
            o = p_hi @ region("v", False, 0, hi_len) + o_blk * corr[..., None]
        else:
            m_new = torch.maximum(m, m_blk)
            c_prev = torch.exp(m - m_new)
            c_blk = torch.exp(m_blk - m_new)
            l = l * c_prev + l_blk * c_blk
            o = o * c_prev[..., None] + o_blk * c_blk[..., None]
            m = m_new
    out = o / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(b, 1, h, hd).to(q.dtype)


def cache_block_attention_ref(entry: dict, q: torch.Tensor,
                              length: torch.Tensor, hi0: int,
                              lo0: int) -> torch.Tensor:
    """Plain version of K6's block mode: one rank's block of a
    sequence-split contiguous cache (its hi codes at global positions
    ``hi0 + i``, its lo codes at ``lo0 + i``, each region's scales after
    the other's as the buffers hold them; a region past every length is
    not read) attended under the global mask ``pos < length``.  Returns
    the block's partial softmax state ``(b, g, h / g, hd + 2)`` f32:
    ``m`` (``-inf`` where no position is valid), ``l`` and the
    unnormalised sum ``o``, over the dequantized f32 codes of both
    regions at once."""
    b, _, h, hd = q.shape
    hi_len, g = entry["k_hi"].shape[1], entry["k_hi"].shape[2]
    rep = h // g
    s_lo = entry["k_lo"].shape[1]
    length = length.to(q.device).reshape(-1).expand(b)[:, None, None, None]
    qg = q.reshape(b, g, rep, hd).float() * (1.0 / math.sqrt(hd))

    def region(name):
        vals = torch.cat([entry[f"{name}_hi"].float(),
                          KV.unpack_nibbles(entry[f"{name}_lo"])], dim=1)
        sc = entry[f"{name}_scale"].float()
        zp = entry[f"{name}_zp"].float()
        return ((vals - zp[..., None]) * sc[..., None]).transpose(1, 2)

    pos = torch.cat([hi0 + torch.arange(hi_len, device=q.device),
                     lo0 + torch.arange(s_lo, device=q.device)])
    valid = pos < length                                  # (b, 1, 1, n)
    s = qg @ region("k").transpose(-1, -2)                # (b, g, rep, n)
    m = torch.where(valid, s, -math.inf).amax(dim=-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    o = p @ region("v")
    return torch.cat([m[..., None], p.sum(dim=-1)[..., None], o], dim=-1)


def merge_states_ref(parts: torch.Tensor, dtype) -> torch.Tensor:
    """Plain version of K6's merge over the ranks' block states ``parts``
    ``(n, b, g, h / g, hd + 2)`` (:func:`cache_block_attention_ref`, in
    rank order; a state with ``m = -inf`` weighs 0): the log-sum-exp
    merge, then ``o / max(l, 1e-30)`` as ``(b, 1, h, hd)`` in ``dtype``."""
    m, l, o = parts[..., 0], parts[..., 1], parts[..., 2:]
    m_tot = m.amax(dim=0)
    c = torch.where(m == -math.inf, 0.0, torch.exp(m - m_tot))
    l_tot = (l * c).sum(dim=0)
    o_tot = (o * c[..., None]).sum(dim=0)
    out = o_tot / torch.clamp_min(l_tot, 1e-30)[..., None]
    b, g, rep, hd = out.shape
    return out.reshape(b, 1, g * rep, hd).to(dtype)


# ------------------------------------------- the standalone kernel library --


def haar_dwt_ref(x: torch.Tensor, levels: int = 3,
                 inverse: bool = False) -> torch.Tensor:
    """Multi-level Haar DWT (or its inverse) along the sequence axis."""
    fn = T.haar_idwt if inverse else T.haar_dwt
    return fn(x, levels=levels, axis=-2)


def wht_ref(x: torch.Tensor, axis: int = -2) -> torch.Tensor:
    return T.wht(x, axis=axis)


#: per-token min-max quantize, then two nibbles a byte at 4 bits (even
#: feature high) or int8 codes shifted by −128 otherwise.  The reference's
#: oracle is its Pallas kernel's expression, so it is K8's plain version.
quant_pack_ref = quant_pack_plain


def unpack_dequant_ref(packed: torch.Tensor, scale: torch.Tensor,
                       zp: torch.Tensor, bits: int = 4,
                       dtype=torch.float32) -> torch.Tensor:
    if bits == 4:
        q = torch.stack([(packed >> 4).float(), (packed & 0xF).float()],
                        dim=-1).reshape(*packed.shape[:-1], -1)
    else:
        q = packed.float()
    return ((q - zp) * scale).to(dtype)


def int8_matmul_ref(qx, qw, sx, zx, sw, zw,
                    out_dtype=torch.float32) -> torch.Tensor:
    """Dequantize both operands, then a float matmul."""
    x = (qx.float() - zx) * sx
    return (x @ _dequant_w(qw, sw, zw)).to(out_dtype)

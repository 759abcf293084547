"""Per-token K/V quantization of the mixed-precision cache (the port of the
token-level helpers of ``repro.serving.kvcache``): per-(token, head)
min-max codes over ``head_dim``, signed int8 for the hi region and two int4
nibbles per byte (hi nibble = even feature) for the lo region.

A cache split over a sequence group (``sharding.SeqGroup``: serving under
a policy) holds on each rank its :class:`SeqBlock`: its block of the hi
region's positions and its block of the lo region's, each split as the
reference's ``cache_shardings`` splits that leaf.  The codes keep the
whole cache's layout; the per-(token, head) scales and zero points ride
with their codes, the hi block's rows then the lo block's (as many rows as
the reference's block of its scale leaf, wherever both regions split
alike).  Scales are per (token, head), so no statistic crosses ranks."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.quant import EPS, div_const
from repro_torch.device import fake_mode_active


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    quantized: bool = True
    num_hi: int = 64
    hi_bits: int = 8
    lo_bits: int = 4


@dataclasses.dataclass(frozen=True)
class SeqBlock:
    """A rank's block of a contiguous cache of ``hi0 + hi_n`` … positions:
    global first position and length of its block of the hi region and of
    the lo region (an unquantized cache's one region is ``hi``), and
    whether this rank's attention reads each (a block held on several
    ranks is read on one)."""
    hi0: int
    hi_n: int
    lo0: int
    lo_n: int
    hi_read: bool = True
    lo_read: bool = True


def seq_block(cfg: KVCacheConfig, capacity: int, group=None) -> SeqBlock:
    """This rank's :class:`SeqBlock` of a cache of ``capacity`` positions
    over the sequence ``group`` (``sharding.SeqGroup.region``: each region
    split over the group where it divides, else over ``model``, else
    whole); the whole cache without a group."""
    hi = min(cfg.num_hi, capacity) if cfg.quantized else capacity
    if group is None:
        return SeqBlock(0, hi, hi, capacity - hi)
    h0, hn, hr = group.region(hi)
    l0, ln, lr = group.region(capacity - hi)
    return SeqBlock(h0, hn, hi + l0, ln, hr, lr)


def quant_tokens(x: torch.Tensor, bits: int) -> tuple:
    """x: (..., kv, hd) → (float-held codes, scale, zp), scale/zp reduced
    over hd."""
    xf = x.float()
    mn = xf.amin(dim=-1)
    mx = xf.amax(dim=-1)
    n = float(2 ** bits - 1)
    scale = torch.clamp_min(div_const(mx - mn, n), EPS)
    zp = torch.round(-mn / scale)
    q = torch.clamp(torch.round(xf / scale[..., None]) + zp[..., None],
                    0.0, n)
    return q, scale, zp


def to_signed8(q: torch.Tensor, zp: torch.Tensor) -> tuple:
    """Shift unsigned 8-bit codes into int8 storage and the zero point
    with them, so ``(q − zp)·s`` is unchanged."""
    return (q - 128.0).to(torch.int8), zp - 128.0


def pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """(..., hd) values in [0, 15] → (..., hd/2) uint8."""
    hi = q[..., 0::2].to(torch.uint8)
    lo = q[..., 1::2].to(torch.uint8)
    return (hi << 4) | lo


def unpack_nibbles(p: torch.Tensor) -> torch.Tensor:
    """(..., hd/2) uint8 → (..., hd) f32 values in [0, 15]."""
    hi = (p >> 4).float()
    lo = (p & 0xF).float()
    return torch.stack([hi, lo], dim=-1).reshape(*p.shape[:-1],
                                                 p.shape[-1] * 2)


def dequant_tokens(q: torch.Tensor, scale: torch.Tensor, zp: torch.Tensor,
                   dtype=torch.bfloat16) -> torch.Tensor:
    return ((q - zp[..., None].float()) * scale[..., None].float()).to(dtype)


# ---------------------------------------------------------------------------
# contiguous cache: init / bulk write (prefill) / token write (decode) / read
# ---------------------------------------------------------------------------


def init_layer_cache(batch: int, seq: int, kv_heads: int, head_dim: int,
                     cfg: KVCacheConfig, device=None,
                     block: Optional[SeqBlock] = None) -> dict:
    """Zero cache for one attention layer (``block``: this rank's block
    of a sequence-split one)."""
    def z(dtype, *shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    blk = block or seq_block(cfg, seq)
    hi, lo = blk.hi_n, blk.lo_n
    if not cfg.quantized:
        return {"k": z(torch.bfloat16, batch, hi, kv_heads, head_dim),
                "v": z(torch.bfloat16, batch, hi, kv_heads, head_dim)}
    out = {}
    for name in ("k", "v"):
        out[f"{name}_hi"] = z(torch.int8, batch, hi, kv_heads, head_dim)
        out[f"{name}_lo"] = z(torch.uint8, batch, lo, kv_heads,
                              head_dim // 2)
    for name in ("k", "v"):
        for suffix in ("scale", "zp"):
            out[f"{name}_{suffix}"] = z(torch.float16, batch, hi + lo,
                                        kv_heads)
    return out


def _region(t: torch.Tensor, p0: int, n: int, bits: int,
            signed: bool) -> tuple:
    """Positions ``[p0, p0 + n)`` of ``t`` (b, s, kv, hd) quantized at
    ``bits``, those at or past ``s`` padded (zero codes, scale 1, zero
    point 0): ``(codes, scale, zp)`` with ``n`` rows."""
    f = torch.nn.functional.pad
    m = max(min(p0 + n, t.shape[1]) - p0, 0)
    q, sc, zp = quant_tokens(t[:, p0:p0 + m], bits)
    if signed:
        buf, zp = to_signed8(q, zp)
    else:
        buf = pack_nibbles(q)
    if n > m:
        buf = f(buf, (0, 0, 0, 0, 0, n - m))
        sc = f(sc, (0, 0, 0, n - m), value=1.0)
        zp = f(zp, (0, 0, 0, n - m))
    return buf, sc, zp


def quantize_full(k: torch.Tensor, v: torch.Tensor, cfg: KVCacheConfig,
                  capacity: Optional[int] = None,
                  block: Optional[SeqBlock] = None) -> dict:
    """Prefill: quantize a whole (b, s, kv, hd) K/V pair into the cache
    layout; ``capacity`` reserves room for decode tokens (zero codes,
    scale 1 and zero point 0 past ``s``).  ``block``: only this rank's
    :class:`SeqBlock` of the cache (each token quantized alike: the
    block is the whole cache's, bit for bit)."""
    s = k.shape[1]
    cap = max(capacity or s, s)
    blk = block or seq_block(cfg, cap)
    if not cfg.quantized:
        pad = (0, 0, 0, 0, 0, cap - s)
        return {n: torch.nn.functional.pad(t.to(torch.bfloat16), pad)[
            :, blk.hi0:blk.hi0 + blk.hi_n] for n, t in (("k", k), ("v", v))}
    out = {}
    for name, t in (("k", k), ("v", v)):
        hi_buf, sc_hi, zp_hi = _region(t, blk.hi0, blk.hi_n, cfg.hi_bits,
                                       True)
        lo_buf, sc_lo, zp_lo = _region(t, blk.lo0, blk.lo_n, cfg.lo_bits,
                                       False)
        out[f"{name}_hi"] = hi_buf
        out[f"{name}_lo"] = lo_buf
        out[f"{name}_scale"] = torch.cat([sc_hi, sc_lo], dim=1).half()
        out[f"{name}_zp"] = torch.cat([zp_hi, zp_lo], dim=1).half()
    return out


def dequantize_segments(entry: dict, dtype=torch.bfloat16) -> tuple:
    """``((k_hi, v_hi), (k_lo, v_lo))`` dequantized, the two regions kept
    apart (decode attends to them as separate segments)."""
    outs = []
    for name in ("k", "v"):
        hi_len = entry[f"{name}_hi"].shape[1]
        sc, zp = entry[f"{name}_scale"], entry[f"{name}_zp"]
        hi = dequant_tokens(entry[f"{name}_hi"].float(), sc[:, :hi_len],
                            zp[:, :hi_len], dtype)
        lo = dequant_tokens(unpack_nibbles(entry[f"{name}_lo"]),
                            sc[:, hi_len:], zp[:, hi_len:], dtype)
        outs.append((hi, lo))
    (k_hi, k_lo), (v_hi, v_lo) = outs
    return (k_hi, v_hi), (k_lo, v_lo)


def dequantize_full(entry: dict, cfg: KVCacheConfig,
                    dtype=torch.bfloat16) -> tuple:
    """The whole cache as dense ``(b, S, kv, hd)`` K and V."""
    if not cfg.quantized:
        return entry["k"].to(dtype), entry["v"].to(dtype)
    (k_hi, v_hi), (k_lo, v_lo) = dequantize_segments(entry, dtype)
    return torch.cat([k_hi, k_lo], dim=1), torch.cat([v_hi, v_lo], dim=1)


def _write_rows(buf: torch.Tensor, rows: torch.Tensor, pos: torch.Tensor,
                token: torch.Tensor) -> None:
    """``buf[rows[i], pos[i]] = token[rows[i]]`` in place (token: (b, ...)
    — one entry per batch row)."""
    if rows.numel():
        buf[rows, pos[rows]] = token[rows].to(buf.dtype)


def write_token(entry: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                pos, cfg: KVCacheConfig,
                block: Optional[SeqBlock] = None) -> dict:
    """Decode: write one (b, 1, kv, hd) K/V at ``pos``, in place.  ``pos``
    is a scalar (every slot at the same length) or a (b,) vector (each
    slot at its own).  A token below ``num_hi`` goes to the int8 region
    with its 8-bit scale / zero point, others to the packed lo region with
    their 4-bit ones — the buffers the reference's one-hot writes give.
    ``block``: the entry is this rank's :class:`SeqBlock` of a
    sequence-split cache; a row whose position lies outside it writes
    nothing here."""
    b = k_new.shape[0]
    dev = k_new.device
    pos = torch.as_tensor(pos, device=dev).to(torch.long).reshape(-1)
    pos = pos.expand(b)
    rows = torch.arange(b, device=dev)
    if not cfg.quantized:
        blk = block or SeqBlock(0, entry["k"].shape[1], 0, 0)
        mine = (pos >= blk.hi0) & (pos < blk.hi0 + blk.hi_n)
        if not fake_mode_active():
            rows = rows[mine]
        for name, t in (("k", k_new), ("v", v_new)):
            _write_rows(entry[name], rows, pos - blk.hi0, t[:, 0])
        return entry
    hi_len = entry["k_hi"].shape[1]
    blk = block or SeqBlock(0, hi_len, hi_len, entry["k_lo"].shape[1])
    in_hi = (pos >= blk.hi0) & (pos < blk.hi0 + blk.hi_n)
    in_lo = (pos >= blk.lo0) & (pos < blk.lo0 + blk.lo_n)
    if fake_mode_active():
        # a fake position holds no value to split the rows by: every row
        # writes past the hi region, as the dry run's decode cells do (a
        # token at 32k or 500k cached positions)
        hi_rows, lo_rows = rows[:0], rows
    else:
        hi_rows, lo_rows = rows[in_hi], rows[in_lo]
    # each row's place among the scales: the hi block's rows, then the lo
    # block's
    at = torch.where(in_hi, pos - blk.hi0, hi_len + pos - blk.lo0)
    for name, t in (("k", k_new), ("v", v_new)):
        t = t[:, 0]
        q8, sc8, zp8 = quant_tokens(t, cfg.hi_bits)
        q8, zp8 = to_signed8(q8, zp8)
        q4, sc4, zp4 = quant_tokens(t, cfg.lo_bits)
        _write_rows(entry[f"{name}_hi"], hi_rows, pos - blk.hi0, q8)
        _write_rows(entry[f"{name}_lo"], lo_rows, pos - blk.lo0,
                    pack_nibbles(q4))
        sel = in_hi[:, None]
        both = torch.cat([hi_rows, lo_rows])
        _write_rows(entry[f"{name}_scale"], both, at,
                    torch.where(sel, sc8, sc4).half())
        _write_rows(entry[f"{name}_zp"], both, at,
                    torch.where(sel, zp8, zp4).half())
    return entry


def cache_bytes(entry: dict) -> int:
    return sum(t.numel() * t.element_size() for t in entry.values())

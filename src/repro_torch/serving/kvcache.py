"""Per-token K/V quantization of the mixed-precision cache (the port of the
token-level helpers of ``repro.serving.kvcache``): per-(token, head)
min-max codes over ``head_dim``, signed int8 for the hi region and two int4
nibbles per byte (hi nibble = even feature) for the lo region."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.quant import EPS, div_const


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    quantized: bool = True
    num_hi: int = 64
    hi_bits: int = 8
    lo_bits: int = 4


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

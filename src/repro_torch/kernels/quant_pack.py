"""Per-token min-max quantize and int4 pack: K8 ``quantize_pack`` (CUDA
source: ``csrc/quant_pack.cu``).

Replaces ``quant_pack_pallas`` (``src/repro/kernels/quant_pack.py``): per
token row, ``scale = max((max − min) / n, 1e-8)`` with ``n = 2^bits − 1``,
``zp = round(−min / scale)``, codes ``clip(round(x / scale) + zp, 0, n)``
(round half to even); at 4 bits two codes per byte with the even feature in
the high nibble, at other widths signed int8 codes with codes and zero
point shifted by −128.  The compiled reference divides by the constant
``n`` as a product with f32(1/n) (:func:`~repro_torch.core.quant.div_const`,
checked against it in the CPU tests); the two per-value divisions are true
divisions.  One warp per token row (see the source note).

Bound on the H100: bytes — one read of the activation, one write of the
codes.
"""

from __future__ import annotations

import torch

from repro_torch.core import quant as Q
from repro_torch.kernels import cuda

BLOCK_S = 256        # the reference's row tile: its shape check

_SIGNATURES = {"quant_pack": [
    cuda.VP, cuda.INT, cuda.LL, cuda.INT, cuda.INT, cuda.FLT, cuda.FLT,
    cuda.INT, cuda.VP, cuda.VP, cuda.VP, cuda.VP]}


def quant_pack_plain(x: torch.Tensor, bits: int = 4) -> tuple:
    """Plain version of K8 (the Pallas ``_quant_kernel``).  ``x``: (b, s,
    d); returns (codes, scale, zp) with scale and zp (b, s, 1) f32."""
    xf = x.float()
    n = float(2 ** bits - 1)
    mn = xf.amin(dim=-1, keepdim=True)
    mx = xf.amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(Q.div_const(mx - mn, n), Q.EPS)
    zp = torch.round(-mn / scale)
    q = torch.clamp(torch.round(xf / scale) + zp, 0.0, n)
    if bits == 4:
        qi = q.to(torch.uint8)
        return (qi[..., 0::2] << 4) | qi[..., 1::2], scale, zp
    return (q - 128.0).to(torch.int8), scale, zp - 128.0


def quantize_pack(x: torch.Tensor, bits: int = 4) -> tuple:
    """K8.  ``x``: (b, s, d) f32, bf16 or f16 with ``s`` a multiple of
    ``min(256, s)`` and, at 4 bits, even ``d``; ``bits`` from 1 to 8.
    Returns packed (b, s, d/2) uint8 at 4 bits, else (b, s, d) int8 codes;
    scale and zp (b, s, 1) f32."""
    if x.dim() != 3:
        raise ValueError(f"quantize_pack takes (b, s, d), got "
                         f"{tuple(x.shape)}")
    b, s, d = x.shape
    bs = min(BLOCK_S, s)
    if bs and s % bs:
        raise ValueError(f"seq {s} not divisible by block_s={bs}")
    if bits == 4 and d % 2:
        raise ValueError(f"4-bit packing pairs features: d={d} is odd")
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must be 1..8, got {bits}")
    if x.device.type == "cpu":
        return quant_pack_plain(x, bits)
    code = cuda.float_code(x.dtype, "K8")
    cuda.require_cuda(x)
    pack4 = bits == 4
    dev = x.device
    q = torch.empty((b, s, d // 2 if pack4 else d),
                    dtype=torch.uint8 if pack4 else torch.int8, device=dev)
    scale = torch.empty((b, s, 1), dtype=torch.float32, device=dev)
    zp = torch.empty((b, s, 1), dtype=torch.float32, device=dev)
    n = float(2 ** bits - 1)
    vec = int(d % (32 if pack4 else 16) == 0 and x.data_ptr() % 16 == 0
              and q.data_ptr() % 16 == 0)
    err = cuda.library("quant_pack", _SIGNATURES).quant_pack(
        x.data_ptr(), code, b * s, d, int(pack4), n, Q.recip32(n), vec,
        q.data_ptr(), scale.data_ptr(), zp.data_ptr(), cuda.stream_ptr(x))
    cuda.check(err, "quantize_pack")
    quantize_pack.launches += 1
    return q, scale, zp


quantize_pack.launches = 0

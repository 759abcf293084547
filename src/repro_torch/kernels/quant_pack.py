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
divisions.  Each row is read once and kept in registers between its min /
max and its quantize, by one warp or by several that join their min / max
(:func:`pack_plan`; see the source note); rows that are not whole 16-byte
words, or unaligned, take a general two-pass path.

Bound on the H100: bytes — one read of the activation, one write of the
codes.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import quant as Q
from repro_torch.kernels import cuda

BLOCK_S = 256        # the reference's row tile: its shape check
WARPS = 8            # warps of a two-pass K8 block; the most a row spans
ROW_BLOCK = 4        # warps of a registers-route block, at least
LANE_WORDS = (1, 2, 4, 8, 16)   # 16-byte words a lane may hold (templates)
ROW_WARPS = (1, 2, 4, 8)        # warps a row may span (its block's share)
LANE_TARGET = 4      # words a lane the plan spreads a row for (see pack_plan)

_SIGNATURES = {"quant_pack": [
    cuda.VP, cuda.INT, cuda.LL, cuda.INT, cuda.INT, cuda.FLT, cuda.FLT,
    cuda.INT, cuda.INT, cuda.VP, cuda.VP, cuda.VP, cuda.VP]}


def pack_plan(d: int, elem: int, x_ptr: int, q_ptr: int) -> dict:
    """K8's route for rows of ``d`` values of ``elem`` bytes at these
    pointers (:func:`_route`, computed once per shape)."""
    return _route(d, elem, x_ptr % 16 == 0 and q_ptr % 16 == 0)


@functools.lru_cache(maxsize=None)
def _route(d: int, elem: int, aligned: bool) -> dict:
    """K8's route for rows of ``d`` values of ``elem`` bytes.  A row that is
    whole 16-byte words (at most ``WARPS x 32 x 16`` of them) with both
    pointers 16-byte aligned is held in registers: ``g`` warps a row
    (blocks of ``max(g, ROW_BLOCK)`` warps), ``nv`` words a lane, word
    ``c`` on lane ``c % 32`` of the row's warp ``(c // 32) % g``.  ``g`` is
    the fewest warps that hold the row at ``LANE_TARGET`` words a lane (all
    ``WARPS`` beyond that): 4 words a lane (63 registers) let 32 warps
    share an SM, which hid the quantize behind the loads better than 8 or
    16 words a lane in fewer warps (a bf16 row of 4096 at 4 bits on an
    H100 at 700 W: 0.0346 ms over 1 warp, 0.0352 over 2, 0.0328 over 4;
    ``tools/probe.py k8 --warps``).  Anything else takes the two passes
    (``nv = 0``), one value at a time."""
    row = d * elem
    words = row // 16
    if aligned and row % 16 == 0 and 0 < words <= WARPS * 32 * LANE_WORDS[-1]:
        g = next((w for w in ROW_WARPS if words <= w * 32 * LANE_TARGET),
                 ROW_WARPS[-1])
        need = -(-words // (32 * g))
        nv = next(v for v in LANE_WORDS if v >= need)
        return dict(g=g, nv=nv, rows_per_block=max(g, ROW_BLOCK) // g)
    return dict(g=1, nv=0, rows_per_block=WARPS)


def lane_words(plan: dict, d: int, elem: int) -> list:
    """The 16-byte words of a row each (warp, lane) of the row holds under
    ``plan`` (registers route), in the kernel's order: the Python twin of
    ``quant_pack_rows``'s indexing."""
    words, g = d * elem // 16, plan["g"]
    return [[[c for j in range(plan["nv"])
              if (c := (wp * 32 + lane) + j * 32 * g) < words]
             for lane in range(32)] for wp in range(g)]


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
    plan = pack_plan(d, x.element_size(), x.data_ptr(), q.data_ptr())
    err = cuda.library("quant_pack", _SIGNATURES).quant_pack(
        x.data_ptr(), code, b * s, d, int(pack4), n, Q.recip32(n), plan["g"],
        plan["nv"], q.data_ptr(), scale.data_ptr(), zp.data_ptr(),
        cuda.stream_ptr(x))
    cuda.check(err, "quantize_pack")
    quantize_pack.launches += 1
    return q, scale, zp


quantize_pack.launches = 0

"""Standalone int8 GEMM with zero-point correction: K7 ``int8_matmul``
(CUDA source: ``csrc/int8_matmul.cu``).  The module is not named after the
function, which ``repro_torch.kernels`` exports under that name.

Replaces ``int8_matmul_pallas`` (``src/repro/kernels/int8_matmul.py``): the
W4A4 / W8A8 deployment matmul of per-row quantized activations against
per-column quantized weights, ``Y = (Σqx·qw − zx·Σqw − zw·Σqx + K·zx·zw) ·
sx · sw`` with int32 accumulation and the sums of both operands taken on
the fly, dequantized once in an f32 epilogue in the reference's order.  K7
is a persistent, warp-specialised kernel: TMA loads into a 4-stage ring,
a warpgroup that transposes the (K, N) weight tiles to the K-major layout
``wgmma`` reads and sums their columns, and two warpgroups on the tensor
cores (``wgmma`` int8, whose 16 extra columns of ones give the rows' sums)
that run the epilogue from their registers (see the source note).  TMA
addresses rows of multiples of 16 bytes: other shapes (every dimension
below 128 may be any size) go through zero-padded copies, which change no
product or sum.

Bound on the H100: integer operations at prefill row counts; bytes (the
weight, read once) at a decode batch of 8 rows.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.stamp_matmul import _epilogue, int_matmul

BLOCK = 128          # the reference's block: its divisibility checks
ALIGN = 16           # TMA: row strides and base addresses, in bytes

_SIGNATURES = {"int8_matmul": [
    cuda.VP, cuda.VP, cuda.VP, cuda.VP, cuda.VP, cuda.VP, cuda.INT,
    cuda.INT, cuda.INT, cuda.INT, cuda.INT, cuda.VP, cuda.INT, cuda.VP]}


def int8_matmul_plain(qx, qw, sx, zx, sw, zw,
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of K7 (the Pallas ``_matmul_kernel``): the exact int32
    product, Σqx and Σqw from the operands, and the f32 epilogue in the
    kernel's order.  ``qx`` (M, K), ``qw`` (K, N) int8; ``sx/zx`` (M, 1),
    ``sw/zw`` (1, N)."""
    y = _epilogue(int_matmul(qx, qw), sx.reshape(-1).float(),
                  zx.reshape(-1).float(), sw.reshape(1, -1).float(),
                  zw.reshape(1, -1).float(),
                  qx.sum(dim=1, dtype=torch.int32),
                  qw.sum(dim=0, dtype=torch.int32), qx.shape[1])
    return y.to(out_dtype)


def _check(qx, qw, sx, zx, sw, zw) -> None:
    """The reference's refusals: a K mismatch, (M, 1) / (1, N) scale and
    zero-point shapes, and M, N, K not divisible by ``min(128, dim)``."""
    if qx.dim() != 2 or qw.dim() != 2:
        raise ValueError(f"int8_matmul takes (M, K) and (K, N) codes, got "
                         f"{tuple(qx.shape)} and {tuple(qw.shape)}")
    m, k = qx.shape
    k2, n = qw.shape
    if k != k2:
        raise ValueError(f"activation K={k} does not match weight K={k2}")
    for name, t, shape in (("sx", sx, (m, 1)), ("zx", zx, (m, 1)),
                           ("sw", sw, (1, n)), ("zw", zw, (1, n))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    bm, bn, bk = min(BLOCK, m), min(BLOCK, n), min(BLOCK, k)
    if (bm and m % bm) or (bn and n % bn) or (bk and k % bk):
        raise ValueError(f"shape ({m}, {n}, {k}) not divisible by blocks "
                         f"({bm}, {bn}, {bk})")


def tma_operands(qx: torch.Tensor, qw: torch.Tensor) -> tuple:
    """``qx`` (M, K) and ``qw`` (K, N) as K7's tensor maps address them:
    unchanged where K and N are multiples of ``ALIGN`` and both start on
    an ``ALIGN``-byte boundary, else copied into zeroed (M, Kp) and (Kp, Np)
    buffers, Kp and Np the next multiples of ``ALIGN`` (at least one).  The
    zeros add nothing to the int32 products or to Σqx and Σqw."""
    m, k = qx.shape
    n = qw.shape[1]
    if k and k % ALIGN == 0 and n % ALIGN == 0 and \
            qx.data_ptr() % ALIGN == 0 and qw.data_ptr() % ALIGN == 0:
        return qx, qw
    kp = max(ALIGN, -(-k // ALIGN) * ALIGN)
    np_ = max(ALIGN, -(-n // ALIGN) * ALIGN)
    xp = qx.new_zeros((m, kp))
    wp = qw.new_zeros((kp, np_))
    xp[:, :k] = qx
    wp[:k, :n] = qw
    return xp, wp


def int8_matmul(qx: torch.Tensor, qw: torch.Tensor, sx: torch.Tensor,
                zx: torch.Tensor, sw: torch.Tensor, zw: torch.Tensor,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """K7.  ``qx``: (M, K) int8; ``qw``: (K, N) int8; ``sx/zx``: (M, 1);
    ``sw/zw``: (1, N).  Returns (M, N) in ``out_dtype`` (f32, bf16 or
    f16)."""
    _check(qx, qw, sx, zx, sw, zw)
    if qx.device.type == "cpu":
        return int8_matmul_plain(qx, qw, sx, zx, sw, zw, out_dtype)
    if qx.dtype != torch.int8 or qw.dtype != torch.int8:
        raise ValueError(f"K7 takes int8 codes, got {qx.dtype} and "
                         f"{qw.dtype}")
    out_code = cuda.float_code(out_dtype, "K7")
    m, k = qx.shape
    n = qw.shape[1]
    vecs = [t.reshape(-1).float().contiguous() for t in (sx, zx, sw, zw)]
    cuda.require_cuda(qx, qw, *vecs)
    qx, qw = tma_operands(qx, qw)
    out = torch.empty((m, n), dtype=out_dtype, device=qx.device)
    err = cuda.library("int8_matmul", _SIGNATURES).int8_matmul(
        qx.data_ptr(), qw.data_ptr(), *(t.data_ptr() for t in vecs), m, n, k,
        qx.shape[1], qw.shape[1], out.data_ptr(), out_code,
        cuda.stream_ptr(qx))
    cuda.check(err, "int8_matmul")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0

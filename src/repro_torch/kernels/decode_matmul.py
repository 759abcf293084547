"""Single-token STaMP decode matmul: K3 ``stamp_decode_matmul`` (CUDA
source: ``csrc/decode_matmul.cu``).

Replaces ``stamp_decode_matmul_pallas`` (``src/repro/kernels/
decode_matmul.py``): per-row 8-bit min-max quantize of the decode tokens,
int8 GEMM against the prepared int8 weight, zero-point epilogue and bias.
Decode spans are single tokens, so no sequence transform applies.

Bound on the H100: bytes — the (K, N) int8 weight is read once per call
and the 8-row product does 16 operations per weight byte.  The kernel
splits K across some 500 blocks so the weight streams from every SM, with
exact int32 atomics joining the partial sums (see the source note).
"""

from __future__ import annotations

import torch

from repro_torch.core.stamp import token_quantize
from repro_torch.kernels import cuda
from repro_torch.kernels.stamp_matmul import _epilogue, int_matmul

MAX_ROWS = 16
_TARGET_BLOCKS = 4 * 132     # about four blocks per SM of an H100

_SIGNATURES = {"stamp_decode_matmul": [
    cuda.VP, cuda.INT, cuda.INT, cuda.INT, cuda.INT, cuda.VP, cuda.VP,
    cuda.VP, cuda.VP, cuda.VP, cuda.INT, cuda.VP, cuda.VP, cuda.VP, cuda.VP,
    cuda.VP, cuda.VP, cuda.INT, cuda.VP]}


def row_quantize8(x: torch.Tensor) -> tuple:
    """Per-row 8-bit asymmetric min-max quantize of ``(M, K)`` rows: signed
    int8 codes plus ``(M,)`` f32 scale and shifted zero point (the Pallas
    decode kernel's quantizer, which is :func:`token_quantize`'s)."""
    q, s, z = token_quantize(x)
    return q, s[:, 0], z[:, 0]


def decode_matmul_plain(x, qw, sw, zw, qw_sum, bias=None,
                        out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of K3.  ``x``: (M, K); returns (M, N)."""
    qx, sx, zx = row_quantize8(x)
    y = _epilogue(int_matmul(qx, qw), sx, zx, sw.reshape(1, -1).float(),
                  zw.reshape(1, -1).float(), qx.sum(dim=1, dtype=torch.int32),
                  qw_sum.reshape(-1), qx.shape[1])
    if bias is not None:
        y = y + bias.reshape(1, -1).float()
    return y.to(out_dtype)


def _kchunk(k: int, n: int) -> int:
    col_blocks = -(-n // 512)
    split = max(1, min(-(-_TARGET_BLOCKS // col_blocks), k // 4))
    chunk = -(-k // split)
    return min(max(4, -(-chunk // 4) * 4), 2048)


def stamp_decode_matmul(x: torch.Tensor, qw: torch.Tensor, sw: torch.Tensor,
                        zw: torch.Tensor, qw_sum: torch.Tensor, bias=None,
                        out_dtype=torch.float32) -> torch.Tensor:
    """K3.  ``x``: (M, K) bf16 or f32 with M <= 16; ``qw``: (K, N) int8;
    ``sw/zw``: (1, N) f32; ``qw_sum``: (1, N) int32 column sums of ``qw``
    (``PreparedLinear.qw_sum``)."""
    if x.device.type == "cpu":
        return decode_matmul_plain(x, qw, sw, zw, qw_sum, bias, out_dtype)
    x = x.contiguous()
    m, k = x.shape
    n = qw.shape[1]
    if m > MAX_ROWS or k % 4 or n % 4 or qw.shape[0] != k:
        raise ValueError(f"K3 takes M <= {MAX_ROWS} rows and K, N multiples "
                         f"of 4; got x {tuple(x.shape)}, qw "
                         f"{tuple(qw.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32) or \
            out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("K3 reads and writes bf16 or f32")
    sw = sw.reshape(-1).float().contiguous()
    zw = zw.reshape(-1).float().contiguous()
    bias = None if bias is None else bias.reshape(-1).float().contiguous()
    if qw_sum.dtype != torch.int32:
        raise ValueError(f"column sums must be int32, got {qw_sum.dtype}")
    qw_sum = qw_sum.reshape(-1).contiguous()
    cuda.require_cuda(x, qw, sw, zw, qw_sum, bias)
    dev = x.device
    qx = torch.empty((m, k), dtype=torch.int8, device=dev)
    sx = torch.empty(m, dtype=torch.float32, device=dev)
    zx = torch.empty(m, dtype=torch.float32, device=dev)
    ints = torch.empty(m + m * n, dtype=torch.int32, device=dev)
    qxsum, acc = ints[:m], ints[m:]
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    lib = cuda.library("decode_matmul", _SIGNATURES)
    err = lib.stamp_decode_matmul(
        x.data_ptr(), int(x.dtype == torch.bfloat16), m, k, n, qw.data_ptr(),
        sw.data_ptr(), zw.data_ptr(), qw_sum.data_ptr(), cuda.ptr(bias),
        _kchunk(k, n), qx.data_ptr(), sx.data_ptr(), zx.data_ptr(),
        qxsum.data_ptr(), acc.data_ptr(), out.data_ptr(),
        int(out_dtype == torch.bfloat16), cuda.stream_ptr(x))
    cuda.check(err, "stamp_decode_matmul")
    stamp_decode_matmul.launches += 1
    return out


stamp_decode_matmul.launches = 0

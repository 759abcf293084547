"""Figure 4b — the bit-width / SQNR trade-off against the number of
high-precision tokens (activation quantization only, 2-D DWT)."""

from __future__ import annotations

from repro_torch.core import quant as Q
from repro_torch.core.stamp import StampConfig, stamp_fake_quant
from repro_torch.device import resolve_device
from repro_torch.paper.common import lvm_activations, timed


def run(device=None, *, hw: tuple = (32, 32), d: int = 128, batch: int = 4,
        uniform_bits: tuple = (4, 5, 6),
        num_hi: tuple = (0, 16, 64, 128, 256)) -> list:
    dev = resolve_device(device)
    x = lvm_activations(batch, hw, d, seed=0, device=dev)
    s = hw[0] * hw[1]
    rows = []
    for bits in uniform_bits:
        q = Q.fake_quant(x, float(bits), axis=-1, compiled=True)
        rows.append({"name": f"fig4b/uniform_a{bits}", "us_per_call": 0.0,
                     "derived": f"avg_bits={bits:.3f},"
                                f"sqnr_db={float(Q.sqnr_db(x, q)):.2f}"})
    for hi in num_hi:
        cfg = StampConfig(seq_transform="dwt2d", levels=3, hw=hw,
                          num_hi_tokens=hi, skip_first_token=False)
        us, q = timed(lambda: stamp_fake_quant(x, cfg), device=dev)
        rows.append({"name": f"fig4b/stamp_hi{hi}", "us_per_call": us,
                     "derived": f"avg_bits={cfg.average_bits(s):.3f},"
                                f"sqnr_db={float(Q.sqnr_db(x, q)):.2f}"})
    return rows

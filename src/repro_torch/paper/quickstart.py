"""Quickstart: STaMP in a minute (the twin of ``examples/quickstart.py``).

On locally correlated activations, at the same average bit width, a
sequence transform with mixed precision beats uniform per-token
quantization — and composes with a feature transform.

    PYTHONPATH=src python -m repro_torch.paper.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core import quant as Q
from repro_torch.core import transforms as T
from repro_torch.core.feature_transforms import hadamard_matrix
from repro_torch.core.stamp import StampConfig, stamp_fake_quant
from repro_torch.data.pipeline import ar_features
from repro_torch.device import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="STaMP quickstart")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    # 1. locally correlated activations, as a transformer block sees them
    #    (batch 8, sequence 2048, features 256; AR(1) along the sequence)
    x = torch.from_numpy(ar_features((8, 2048, 256), rho=0.95,
                                     seed=0)).to(dev)
    # 2. uniform per-token quantization at the matched 4.125-bit budget
    bits_budget = (64 * 8 + (2048 - 64) * 4) / 2048
    uniform = Q.fake_quant(x, bits_budget, axis=-1)
    print(f"uniform A{bits_budget:.3f}:       SQNR = "
          f"{float(Q.sqnr_db(x, uniform)):6.2f} dB")
    # 3. STaMP: Haar DWT along the sequence, 64 tokens at 8 bits, rest at 4
    cfg = StampConfig(seq_transform="dwt", num_hi_tokens=64,
                      skip_first_token=False)
    stamped = stamp_fake_quant(x, cfg)
    print(f"STaMP  A{cfg.average_bits(2048):.3f} (DWT+MP): SQNR = "
          f"{float(Q.sqnr_db(x, stamped)):6.2f} dB")
    # 4. ... composed with a feature transform (QuaRot-style Hadamard)
    r = torch.tensor(hadamard_matrix(256), device=dev)
    tq = Q.fake_quant(T.haar_dwt(x, levels=5) @ r,
                      Q.mixed_precision_bits(2048, 64, device=dev), axis=-1)
    both = T.haar_idwt(tq @ r.T, levels=5)
    print(f"STaMP + Hadamard:        SQNR = "
          f"{float(Q.sqnr_db(x, both)):6.2f} dB")
    # 5. the energy behind it (Fig. 3b)
    e = torch.sum(T.haar_dwt(x, levels=5) ** 2, dim=(0, -1))
    print(f"\nenergy in first 64/2048 transformed tokens: "
          f"{float(e[:64].sum() / e.sum()) * 100:.1f}% (uniform would be "
          f"3.1%)")


if __name__ == "__main__":
    main()

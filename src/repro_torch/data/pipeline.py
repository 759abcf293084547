"""Deterministic synthetic calibration tokens (a numpy-only copy of
``repro.data.pipeline``'s generator).

An order-1 Markov chain over the vocabulary with a banded transition
kernel plus jump noise gives activations the strong local correlation
along the sequence that STaMP exploits (Fig. 3a).  Batch ``i`` depends only
on ``(seed, i)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    bandwidth: int = 8        # Markov band width (locality strength)
    jump_prob: float = 0.1    # probability of a non-local jump


def _batch_rng(cfg: DataConfig, step: int, host: int = 0) -> np.random.Generator:
    # calibration batches use negative step ids; SeedSequence wants uint32
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed & 0xFFFFFFFF,
                                (step + 2**31) & 0xFFFFFFFF,
                                host & 0xFFFFFFFF]))


def markov_batch(cfg: DataConfig, step: int, host: int = 0,
                 hosts: int = 1) -> dict:
    """One (tokens, labels) batch; labels are next-token shifted."""
    rng = _batch_rng(cfg, step, host)
    b = cfg.global_batch // hosts
    s = cfg.seq_len
    v = cfg.vocab_size
    jumps = rng.random((b, s)) < cfg.jump_prob
    steps = rng.integers(-cfg.bandwidth, cfg.bandwidth + 1, size=(b, s))
    jump_targets = rng.integers(0, v, size=(b, s))
    tokens = np.empty((b, s + 1), np.int32)
    tokens[:, 0] = rng.integers(0, v, size=b)
    for i in range(1, s + 1):
        walk = (tokens[:, i - 1] + steps[:, i - 1]) % v
        tokens[:, i] = np.where(jumps[:, i - 1], jump_targets[:, i - 1], walk)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def calibration_batches(cfg: DataConfig, num_batches: int = 8,
                        host: int = 0) -> list:
    """Held-out batches (negative step ids) for the PTQ calibration pass."""
    return [markov_batch(cfg, -(i + 1), host) for i in range(num_batches)]

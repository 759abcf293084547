"""Deterministic synthetic data (a numpy-only copy of
``repro.data.pipeline``).

An order-1 Markov chain over the vocabulary with a banded transition
kernel plus jump noise gives activations the strong local correlation
along the sequence that STaMP exploits (Fig. 3a); AR(1) feature sequences
and latent grids stand in for calibration sets and LVM activations.  Batch
``i`` depends only on ``(seed, i)``, so :class:`DataIterator` restores
from its step counter.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

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


def ar_features(shape: tuple, rho: float = 0.95, seed: int = 0,
                axis: int = -2) -> np.ndarray:
    """AR(1) process along ``axis``: locally correlated activations."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    x = np.moveaxis(x, axis, 0)
    out = np.empty_like(x)
    out[0] = x[0]
    scale = np.sqrt(1 - rho ** 2)
    for i in range(1, x.shape[0]):
        out[i] = rho * out[i - 1] + scale * x[i]
    return np.moveaxis(out, 0, axis)


def ar_grid_features(batch: int, hw: tuple, d: int, rho: float = 0.9,
                     seed: int = 0) -> np.ndarray:
    """A 2-D locally correlated latent grid flattened to a sequence (the
    block-Toeplitz structure of DiT activations, Fig. 3a)."""
    h, w = hw
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, h, w, d)).astype(np.float32)
    scale = np.sqrt(1 - rho ** 2)
    for i in range(1, h):
        x[:, i] = rho * x[:, i - 1] + scale * x[:, i]
    for j in range(1, w):
        x[:, :, j] = rho * x[:, :, j - 1] + scale * x[:, :, j]
    return x.reshape(batch, h * w, d)


@dataclasses.dataclass
class DataIterator:
    """Restorable iterator: ``state`` is the step counter."""

    cfg: DataConfig
    step: int = 0
    host: int = 0
    hosts: int = 1

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        batch = markov_batch(self.cfg, self.step, self.host, self.hosts)
        self.step += 1
        return batch

    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])


def calibration_batches(cfg: DataConfig, num_batches: int = 8,
                        host: int = 0) -> list:
    """Held-out batches (negative step ids) for the PTQ calibration pass."""
    return [markov_batch(cfg, -(i + 1), host) for i in range(num_batches)]

"""Deterministic fault injection for the paged serving engine (the port's
own copy of ``repro.serving.faults``: the same plan draws the same faults
for the same seed, numpy only).

A :class:`FaultPlan` is a *seeded schedule* of failures the engine, the
block allocator, and the swap layer consult at well-defined points:

* **page exhaustion** — the allocator reports "no free pages" on the steps
  the plan names (or draws, at ``exhaust_rate``, from a counter-keyed
  PRNG), driving real preemption storms through the production preemption
  path rather than a mocked one;
* **swap-in corruption** — the host copy of a preempted request's pages is
  bit-flipped before ``insert_pages`` restores it; the per-swap CRC32
  checksums recorded by ``extract_pages`` must refuse the restore
  (`paged_kvcache.SwapCorruption`), and the engine must fail exactly that
  request;
* **device-step NaN/Inf** — a chosen request's logits row is overwritten
  with NaN after the device step, exercising the ``ServeConfig.
  numerics_guard`` quarantine (and, on fused engines, the
  fused→reference demotion);
* **prefix-cache flush** — the allocator's prefix cache is dropped whole
  (``BlockAllocator.flush_cache``) on the steps the plan names, an
  eviction storm proving that requests already sharing cached pages keep
  their references, finish bit-identically, and leak nothing once the
  registrations under them disappear.

Every decision is a pure function of ``(seed, fault kind, event
ordinal)`` — never of wall-clock time or host state — so a chaos run is
exactly reproducible: the chaos tests replay a plan twice and pin the
surviving requests' tokens bit-for-bit against a fault-free run.
"""

from __future__ import annotations

import dataclasses
from typing import FrozenSet, Optional, Tuple

import numpy as np

# kind codes folded into the per-decision PRNG seed so the fault
# streams are independent even at equal ordinals
_KIND_EXHAUST, _KIND_CORRUPT, _KIND_NAN, _KIND_FLUSH = 1, 2, 3, 4


def _draw(seed: int, kind: int, *key: int) -> float:
    """One uniform [0, 1) draw keyed by (seed, kind, event ordinal) — the
    same event always draws the same number, independent of call order."""
    return float(np.random.default_rng((seed, kind) + key).random())


@dataclasses.dataclass
class FaultPlan:
    """Seeded deterministic fault schedule (see module docstring).

    Explicit schedules (``exhaust_steps`` / ``corrupt_swap_ins`` /
    ``nan_faults``) fire regardless of the rates; the ``*_rate`` fields add
    seeded random faults on top, restricted to engine steps inside
    ``window`` (``[start, end)``; ``None`` = every step).  ``injected``
    counts what actually fired, for tests and the engine's event trace.
    """

    seed: int = 0
    # -- explicit schedules -------------------------------------------------
    exhaust_steps: FrozenSet[int] = frozenset()    # engine step numbers
    corrupt_swap_ins: FrozenSet[int] = frozenset()  # swap-in ordinals, 0-based
    nan_faults: FrozenSet[Tuple[int, int]] = frozenset()  # (uid, gen_index)
    flush_prefix_steps: FrozenSet[int] = frozenset()  # engine step numbers
    # -- seeded rates -------------------------------------------------------
    exhaust_rate: float = 0.0
    corrupt_rate: float = 0.0
    nan_rate: float = 0.0
    flush_rate: float = 0.0
    window: Optional[Tuple[int, int]] = None       # steps [start, end)

    def __post_init__(self):
        self.exhaust_steps = frozenset(int(s) for s in self.exhaust_steps)
        self.corrupt_swap_ins = frozenset(int(n)
                                          for n in self.corrupt_swap_ins)
        self.nan_faults = frozenset((int(u), int(g))
                                    for u, g in self.nan_faults)
        self.flush_prefix_steps = frozenset(int(s)
                                            for s in self.flush_prefix_steps)
        self._step = 0
        self._swap_ins = 0
        self._counted_steps: set = set()
        self._flushed_steps: set = set()
        self.injected = {"exhaustion": 0, "swap_corruption": 0, "nan": 0,
                         "prefix_flush": 0}

    # ------------------------------------------------------------------
    def begin_step(self, step: int) -> None:
        """Engine calls this once per scheduler step, before planning."""
        self._step = int(step)

    def _in_window(self) -> bool:
        return self.window is None or \
            self.window[0] <= self._step < self.window[1]

    # ------------------------------------------------------------------
    def exhausted(self) -> bool:
        """True when the allocator must report exhaustion this step.
        Stable within a step (keyed on the step number), so every
        ``can_allocate`` probe of one plan sees the same answer."""
        hit = self._step in self.exhaust_steps or (
            self._in_window() and self.exhaust_rate > 0.0 and
            _draw(self.seed, _KIND_EXHAUST, self._step) < self.exhaust_rate)
        if hit and self._step not in self._counted_steps:
            self._counted_steps.add(self._step)
            self.injected["exhaustion"] += 1
        return hit

    def flush_prefix(self) -> bool:
        """True when the prefix cache must be dropped this step.  Stable
        per step (and counted once), like `exhausted` — the engine calls it
        in its plan phase and runs ``alloc.flush_cache()`` on a hit."""
        hit = self._step in self.flush_prefix_steps or (
            self._in_window() and self.flush_rate > 0.0 and
            _draw(self.seed, _KIND_FLUSH, self._step) < self.flush_rate)
        if hit and self._step not in self._flushed_steps:
            self._flushed_steps.add(self._step)
            self.injected["prefix_flush"] += 1
        return hit

    def corrupt_swap(self, uid: int) -> bool:
        """Called once per swap-in (ordinal counter): corrupt this one?"""
        n = self._swap_ins
        self._swap_ins += 1
        hit = n in self.corrupt_swap_ins or (
            self._in_window() and self.corrupt_rate > 0.0 and
            _draw(self.seed, _KIND_CORRUPT, n) < self.corrupt_rate)
        if hit:
            self.injected["swap_corruption"] += 1
        return hit

    def nan_logits(self, uid: int, gen_index: int) -> bool:
        """Overwrite this request's logits with NaN at its
        ``gen_index``-th generated token?  Keyed on (uid, gen_index), not
        the step number, so the targeted token is schedule-independent —
        the same request NaNs at the same point under any contention."""
        hit = (uid, gen_index) in self.nan_faults or (
            self._in_window() and self.nan_rate > 0.0 and
            _draw(self.seed, _KIND_NAN, uid, gen_index) < self.nan_rate)
        if hit:
            self.injected["nan"] += 1
        return hit


def corrupt_swapped(swapped: dict, seed: int) -> dict:
    """Deep-copy a swap-out dict and flip one byte of the first non-empty
    saved array (sorted key order, so the choice is deterministic given the
    seed picks only the byte index).  Simulates host-RAM / transfer
    corruption while the request sat preempted; ``insert_pages`` must catch
    it via the recorded checksums, never restore the garbage.  Layer keys
    may be strings (the reference's) or layer indices (the port's)."""
    rng = np.random.default_rng(seed)
    out: dict = {}
    target = None
    # the port's swap dict keys its layers by index beside the string
    # CRC_KEY: order ints first, then strings, each among its own kind
    for layer_key in sorted(swapped, key=lambda k: (isinstance(k, str), k)):
        layer = swapped[layer_key]
        if not isinstance(layer, dict):
            out[layer_key] = layer
            continue
        copied = {}
        for name in sorted(layer):
            arr = layer[name]
            arr = np.asarray(arr).copy() if isinstance(arr, np.ndarray) \
                else arr
            copied[name] = arr
            if target is None and isinstance(arr, np.ndarray) \
                    and arr.nbytes > 0 and layer_key != "__crc__":
                target = arr
        out[layer_key] = copied
    if target is None:
        raise ValueError("nothing to corrupt: swap dict holds no array data")
    flat = target.reshape(-1).view(np.uint8)
    flat[int(rng.integers(flat.size))] ^= 0xFF
    return out

"""Typed metrics registry: counters, gauges, fixed-bucket histograms (the
port's own copy of ``repro.obs.metrics``; ``to_json`` and
``to_prometheus`` render byte-identically to it for the same calls).

Pure stdlib — importable from benches, the serve CLI and tests without
pulling in torch.  One :class:`MetricsRegistry` per engine; both serving
engines expose their legacy ``stats`` dict as a read-only view over the
registry's counters, so there is exactly one source of truth.

Design notes
------------
* Metrics are grouped into *families* (one name, one type, one help
  string, one bucket layout).  A family has labeled children — e.g.
  ``quant_clip_rate{site="qkv"}`` — addressed by a sorted label tuple.
  Calling ``registry.counter(name, labels=...)`` is get-or-create and
  always returns the same child object, so call sites don't cache.
* Histograms use fixed upper-bound buckets (Prometheus ``le``
  semantics: bucket *i* counts observations ``v <= edge[i]``, plus one
  overflow bucket).  `exponential_buckets` builds the geometric layouts
  used for latency / TTFT / queue-wait.  Percentiles are estimated by
  linear interpolation inside the covering bucket, which bounds the
  relative error by the bucket growth factor — good enough for p50/p99
  reporting and far cheaper than keeping raw sample lists.
* ``reset(exclude=...)`` zeroes values but keeps registrations, so a
  bench can drop warmup observations while preserving cumulative
  counters like ``recompiles``.
* The injectable ``clock`` only stamps snapshots (wall-clock metadata);
  engine phase timing uses its own observability clock (see trace.py).
"""

from __future__ import annotations

import bisect
import json
import re
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

LabelMap = Optional[Dict[str, str]]
LabelKey = Tuple[Tuple[str, str], ...]


def exponential_buckets(start: float, factor: float, count: int) -> Tuple[float, ...]:
    """``count`` geometric bucket upper bounds: start, start*factor, ..."""
    if start <= 0.0 or factor <= 1.0 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    edges, v = [], start
    for _ in range(count):
        edges.append(v)
        v *= factor
    return tuple(edges)


# 100 µs .. ~210 s, factor 2 — covers interpret-mode CPU latencies end to end.
LATENCY_BUCKETS = exponential_buckets(1e-4, 2.0, 22)


def _label_key(labels: LabelMap) -> LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render_name(name: str, key: LabelKey) -> str:
    if not key:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonically increasing value (float internally; expose as-is)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a gauge")
        self.value += n

    def _reset(self) -> None:
        self.value = 0.0


class Gauge:
    """Point-in-time value; set freely."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n

    def _reset(self) -> None:
        self.value = 0.0


class Histogram:
    """Fixed-bucket histogram with Prometheus ``le`` semantics."""

    __slots__ = ("edges", "counts", "sum", "count")

    def __init__(self, edges: Sequence[float]):
        self.edges: Tuple[float, ...] = tuple(edges)
        if list(self.edges) != sorted(set(self.edges)):
            raise ValueError("bucket edges must be strictly increasing")
        self.counts: List[int] = [0] * (len(self.edges) + 1)  # +overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        # first edge >= v  (bucket i holds v <= edges[i])
        self.counts[bisect.bisect_left(self.edges, v)] += 1
        self.sum += v
        self.count += 1

    def percentile(self, q: float) -> float:
        """Estimate the q-quantile (q in [0, 1]) by interpolating inside
        the covering bucket.  Returns 0.0 on an empty histogram; values
        in the overflow bucket report the last finite edge."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1]")
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = 0.0
        for i, c in enumerate(self.counts):
            if cum + c >= target and c > 0:
                if i >= len(self.edges):        # overflow bucket
                    return self.edges[-1]
                lo = self.edges[i - 1] if i > 0 else 0.0
                hi = self.edges[i]
                frac = (target - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
        return self.edges[-1]

    def _reset(self) -> None:
        self.counts = [0] * len(self.counts)
        self.sum = 0.0
        self.count = 0


class _Family:
    __slots__ = ("name", "type", "help", "buckets", "children")

    def __init__(self, name: str, typ: str, help: str,
                 buckets: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.type = typ
        self.help = help
        self.buckets = buckets
        self.children: Dict[LabelKey, object] = {}

    def child(self, key: LabelKey):
        c = self.children.get(key)
        if c is None:
            if self.type == "counter":
                c = Counter()
            elif self.type == "gauge":
                c = Gauge()
            else:
                c = Histogram(self.buckets)
            self.children[key] = c
        return c


class MetricsRegistry:
    """One namespace of metric families; the single stats surface an
    engine (or bench) publishes through."""

    def __init__(self, clock=time.time):
        self._families: Dict[str, _Family] = {}
        self._clock = clock

    # -- get-or-create accessors ----------------------------------------
    def _family(self, name: str, typ: str, help: str,
                buckets: Optional[Sequence[float]] = None) -> _Family:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        fam = self._families.get(name)
        if fam is None:
            fam = _Family(name, typ, help,
                          tuple(buckets) if buckets is not None else None)
            self._families[name] = fam
        elif fam.type != typ:
            raise ValueError(f"metric {name!r} already registered as "
                             f"{fam.type}, requested {typ}")
        return fam

    def counter(self, name: str, help: str = "",
                labels: LabelMap = None) -> Counter:
        return self._family(name, "counter", help).child(_label_key(labels))

    def gauge(self, name: str, help: str = "",
              labels: LabelMap = None) -> Gauge:
        return self._family(name, "gauge", help).child(_label_key(labels))

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None,
                  labels: LabelMap = None) -> Histogram:
        fam = self._family(name, "histogram", help,
                           buckets if buckets is not None else LATENCY_BUCKETS)
        return fam.child(_label_key(labels))

    # -- lifecycle -------------------------------------------------------
    def reset(self, exclude: Iterable[str] = ()) -> None:
        """Zero every metric value (keep registrations).  Families named
        in ``exclude`` are preserved — e.g. cumulative ``recompiles``."""
        skip = set(exclude)
        for fam in self._families.values():
            if fam.name in skip:
                continue
            for child in fam.children.values():
                child._reset()

    # -- exposition ------------------------------------------------------
    def snapshot(self) -> dict:
        """Plain-data view: {"t", "counters", "gauges", "histograms"}."""
        out = {"t": float(self._clock()),
               "counters": {}, "gauges": {}, "histograms": {}}
        for fam in sorted(self._families.values(), key=lambda f: f.name):
            for key in sorted(fam.children):
                child = fam.children[key]
                rname = _render_name(fam.name, key)
                if fam.type == "counter":
                    out["counters"][rname] = child.value
                elif fam.type == "gauge":
                    out["gauges"][rname] = child.value
                else:
                    out["histograms"][rname] = {
                        "edges": list(child.edges),
                        "counts": list(child.counts),
                        "sum": child.sum,
                        "count": child.count,
                    }
        return out

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (v0.0.4)."""
        lines: List[str] = []
        for fam in sorted(self._families.values(), key=lambda f: f.name):
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.type}")
            for key in sorted(fam.children):
                child = fam.children[key]
                if fam.type in ("counter", "gauge"):
                    lines.append(f"{_render_name(fam.name, key)} "
                                 f"{_fmt(child.value)}")
                else:
                    cum = 0
                    for edge, c in zip(child.edges, child.counts):
                        cum += c
                        le = key + (("le", _fmt(edge)),)
                        lines.append(f"{_render_name(fam.name + '_bucket', le)}"
                                     f" {cum}")
                    le = key + (("le", "+Inf"),)
                    lines.append(f"{_render_name(fam.name + '_bucket', le)} "
                                 f"{child.count}")
                    lines.append(f"{_render_name(fam.name + '_sum', key)} "
                                 f"{_fmt(child.sum)}")
                    lines.append(f"{_render_name(fam.name + '_count', key)} "
                                 f"{child.count}")
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))

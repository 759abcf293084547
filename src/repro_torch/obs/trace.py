"""Structured engine events, step-phase timing, and Chrome-trace export
(the port's own copy of ``repro.obs.trace``, pure stdlib).

:class:`Event` replaces the mixed-arity ``(step, kind, payload)`` tuples
the engines used to append to ``engine.events``: every event now carries
the same fields (step, kind, uid, timestamp, optional duration/phase,
plus a kind-specific ``fields`` dict).  Tuple-unpacking call sites keep
working — ``for step, kind, payload in engine.events`` — because
``__iter__`` reconstructs the legacy 3-tuple, including the historical
payload shapes (``(uid, start, end)`` for prefill chunks, the sorted uid
tuple for decode batches, ``(uid, error)`` for error terminals).

:class:`StepTimer` wraps the three phases of an engine step — ``plan``
(deadlines + scheduler), ``dispatch`` (host batch build + the device
program + result materialization), ``post`` (token post-loops) — into
histogram observations and per-step phase events.  It reads the
*observability* clock exactly twice per phase (enter/exit), so a
fake tick-clock test can pin exact durations; engine semantics
(deadlines, TTFT) stay on the engine's own clock, untouched.

`export_chrome_trace` renders the event ring as Chrome trace-event JSON
(the ``{"traceEvents": [...]}`` object form): one thread per request
showing its WAITING → PREFILLING → DECODING span timeline with
preempt/resume/swap/quarantine instant marks, plus one thread of
per-step phase slices.  Load the file in https://ui.perfetto.dev or
``chrome://tracing``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional

# kinds whose legacy payload was `(uid, error)` when an error string is
# present (engine._terminate) — everything else carried a bare uid,
# except the special cases handled in Event.payload.
_TERMINAL_KINDS = ("finish", "fail", "cancel", "reject", "shed",
                   "watchdog", "swap_corrupt")

STEP_PHASES = ("plan", "dispatch", "post")


@dataclasses.dataclass
class Event:
    """One engine occurrence with a stable schema.

    ``fields`` holds kind-specific detail: ``start``/``end`` for
    ``prefill_chunk``, ``uids`` for ``decode``, ``error`` for failure
    terminals, ``to`` for ``demote``, ``site``/``clip_rate`` for
    ``quant_clip_alert``.
    """
    step: int
    kind: str
    uid: Optional[int] = None
    t: float = 0.0                 # observability-clock timestamp (s)
    dur: Optional[float] = None    # span length for phase/chunk slices (s)
    phase: Optional[str] = None    # "plan" | "dispatch" | "post" for phases
    fields: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def payload(self):
        """The legacy third tuple slot, per historical kind conventions."""
        if self.kind == "prefill_chunk":
            return (self.uid, self.fields["start"], self.fields["end"])
        if self.kind == "decode":
            return self.fields["uids"]
        if self.kind == "demote":
            return self.fields["to"]
        if self.kind == "fault_exhaust":
            return self.step
        err = self.fields.get("error")
        if err is not None:
            return (self.uid, err)
        return self.uid

    def __iter__(self):
        # legacy tuple-unpacking: `for step, kind, payload in events`
        return iter((self.step, self.kind, self.payload))


class StepTimer:
    """Times named step phases into a histogram family and emits one
    ``phase`` event per occurrence.

    ``clock`` is called exactly twice per phase (enter + exit); pass the
    engine's observability tick so event timestamps advance with phase
    boundaries.  ``on_phase(name, t0, dur)`` lets the engine append the
    phase slice to its event ring.
    """

    def __init__(self, metrics, clock: Callable[[], float],
                 on_phase: Optional[Callable[[str, float, float], None]] = None,
                 buckets=None):
        self._metrics = metrics
        self._clock = clock
        self._on_phase = on_phase
        self._buckets = buckets

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = self._clock()
        try:
            yield
        finally:
            dur = self._clock() - t0
            self._metrics.histogram(
                "step_phase_s", help="engine step phase wall time",
                buckets=self._buckets, labels={"phase": name}).observe(dur)
            if self._on_phase is not None:
                self._on_phase(name, t0, dur)


# ---------------------------------------------------------------------------
# Chrome trace-event export
# ---------------------------------------------------------------------------

_INSTANT_NAMES = {
    "preempt": "preempt (pages swapped out)",
    "resume": "resume (pages swapped in)",
    "deadline_miss": "deadline miss",
    "nan_quarantine": "NaN quarantine",
    "fault_nan": "fault: injected NaN",
    "fault_corrupt": "fault: swap corruption",
    "quant_clip_alert": "quant clip alert",
}

_PID = 1
_TID_STEPS = 0


def _us(t: float, t0: float) -> int:
    return int(round((t - t0) * 1e6))


def export_chrome_trace(events: Iterable, engine: str = "engine") -> dict:
    """Render an engine event ring as a Chrome trace-event JSON object.

    One pid (the engine); tid 0 carries the per-step phase slices, one
    tid per request uid carries that request's lifecycle span timeline:
    WAITING (submit→admit, and preempt→resume while swapped out),
    PREFILLING (admit→first token, with per-chunk slices), DECODING
    (first token→terminal), instant marks for preempt/resume/faults/
    quarantines, and a terminal instant naming the outcome.
    """
    evs: List[Event] = [e for e in events if isinstance(e, Event)]
    if not evs:
        return {"traceEvents": [],
                "displayTimeUnit": "ms",
                "metadata": {"engine": engine}}
    t0 = min(e.t for e in evs)
    out: List[dict] = [
        {"name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
         "args": {"name": f"repro serving: {engine}"}},
        {"name": "thread_name", "ph": "M", "pid": _PID, "tid": _TID_STEPS,
         "args": {"name": "engine steps"}},
    ]
    named_tids = set()

    def tid_for(uid: int) -> int:
        tid = uid + 1          # tid 0 is the step-phase thread
        if tid not in named_tids:
            named_tids.add(tid)
            out.append({"name": "thread_name", "ph": "M", "pid": _PID,
                        "tid": tid, "args": {"name": f"req {uid}"}})
        return tid

    def span(uid: int, name: str, ts: float, te: float, args=None):
        out.append({"name": name, "ph": "X", "pid": _PID,
                    "tid": tid_for(uid), "ts": _us(ts, t0),
                    "dur": max(_us(te, t0) - _us(ts, t0), 0),
                    "args": args or {}})

    def instant(uid: int, name: str, t: float, args=None):
        out.append({"name": name, "ph": "i", "s": "t", "pid": _PID,
                    "tid": tid_for(uid), "ts": _us(t, t0),
                    "args": args or {}})

    # -- per-step phase slices ------------------------------------------
    for e in evs:
        if e.kind == "phase":
            out.append({"name": e.phase or "phase", "ph": "X", "pid": _PID,
                        "tid": _TID_STEPS, "ts": _us(e.t, t0),
                        "dur": max(_us(e.t + (e.dur or 0.0), t0)
                                   - _us(e.t, t0), 0),
                        "args": {"step": e.step}})

    # -- per-request lifecycle spans ------------------------------------
    # state machine per uid: (state name, state start time)
    state: Dict[int, tuple] = {}
    saw_first: Dict[int, bool] = {}
    last_t = max(e.t + (e.dur or 0.0) for e in evs)

    def close(uid: int, te: float, args=None):
        cur = state.pop(uid, None)
        if cur is not None:
            span(uid, cur[0], cur[1], te, args)

    for e in evs:
        uid, k = e.uid, e.kind
        if uid is None or k in ("phase", "decode"):
            continue
        if k == "submit":
            state[uid] = ("WAITING", e.t)
            saw_first[uid] = False
        elif k == "admit":
            close(uid, e.t)
            state[uid] = ("DECODING" if saw_first.get(uid) else "PREFILLING",
                          e.t)
        elif k == "preempt":
            close(uid, e.t)
            state[uid] = ("WAITING", e.t)
            instant(uid, _INSTANT_NAMES[k], e.t)
        elif k == "resume":
            instant(uid, _INSTANT_NAMES[k], e.t)
        elif k == "prefill_chunk":
            span(uid, f"prefill[{e.fields.get('start')}:"
                      f"{e.fields.get('end')})",
                 e.t, e.t + (e.dur or 0.0), {"step": e.step})
        elif k == "first_token":
            close(uid, e.t)
            saw_first[uid] = True
            state[uid] = ("DECODING", e.t)
            instant(uid, "first token", e.t)
        elif k in _TERMINAL_KINDS:
            close(uid, e.t)
            args = {"step": e.step}
            if e.fields.get("error"):
                args["error"] = e.fields["error"]
            instant(uid, f"terminal: {k}", e.t, args)
        elif k in _INSTANT_NAMES:
            instant(uid, _INSTANT_NAMES[k], e.t,
                    dict(e.fields) if e.fields else None)
        else:
            instant(uid, k, e.t, dict(e.fields) if e.fields else None)

    # requests still open when the ring was exported (or whose submit
    # fell off the ring): close at the last observed timestamp
    for uid in list(state):
        close(uid, last_t, {"open": True})

    return {"traceEvents": out,
            "displayTimeUnit": "ms",
            "metadata": {"engine": engine}}

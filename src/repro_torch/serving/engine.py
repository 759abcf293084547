"""Serving engines (the port of ``repro.serving.engine``): lockstep bucketed
batching over the contiguous mixed-precision cache, and continuous batching
over the block-paged one.  Both share one request API (``submit`` → ``run``
→ :class:`Request` s in one terminal state each, with tokens, TTFT and
latency) and one observability surface, in :class:`_EngineBase`: a
``metrics`` registry (``stats`` is a dict view of it), an ``events`` ring
of typed :class:`~repro_torch.obs.trace.Event` s, ``plan`` / ``dispatch``
/ ``post`` step phases, and quant telemetry folded in per step.

:class:`BucketedEngine` groups up to ``max_batch`` requests, right-pads
their prompts to the bucket, runs one `lm.prefill` reading each row's
logits at its last prompt token, then decodes in lockstep with per-slot
positions (`lm.decode_step` at ``len + step``): pad tokens sit after every
prompt position, so causal attention never sees them, and each first
generated token overwrites the pad K/V at position ``len``.

In :class:`PagedServingEngine` each engine step the scheduler
(`serving/scheduler.py`) admits waiting requests into free slots, reserves
pages (preempting the latest arrival on exhaustion and swapping its pages
to host memory), adopts cached prompt prefixes (copy-on-write on a mid-page
match), and plans prefill chunks plus the decode slot array.  In
``step_mode="unified"`` the step runs as ONE forward, `lm.paged_unified_step`,
with up to ``max_prefills`` chunk rows bucketed to 0, 1, 2, 4, …
``max_prefills``; in ``"two_call"`` it runs one chunk through
`lm.paged_prefill_chunk` and then the decode slots through
`lm.paged_decode_step`, scheduling exactly as the reference's two-call
engine (one chunk a step, no transform-window alignment).  A hybrid or
pure-SSM stack's Mamba layers keep their state in a slot-dense pool beside
the pages: chunks carry it across their boundaries through the request's
slot row, decode advances only the running slots, a preempted request's
state swaps out with its pages, a stack without attention takes no pages
at all, and prefix caching is off with Mamba layers.  Around the step:
deadlines, bounded-queue shedding, cancellation, a no-progress watchdog,
the NaN/Inf numerics guard with fused → reference demotion, and the
fault-injection hooks of `serving/faults.py`.  Greedy sampling: each step
moves its token ids, the guard's finite flags and the telemetry scalars to
the host in one transfer.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.obs import quantstats as QS
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Event, StepTimer
from repro_torch.serving import paged_kvcache as PKV
from repro_torch.serving.faults import FaultPlan, corrupt_swapped
from repro_torch.serving.scheduler import (CANCELLED, PREFILLING, REJECTED,
                                           RUNNING, PrefillWork,
                                           SchedRequest, Scheduler,
                                           SchedulerConfig)


def _transform_window(stamp, chunk: int) -> int:
    """A Haar DWT / WHT at L levels mixes tokens in blocks of 2^L, so
    non-final chunk ends align to that multiple (when it fits a chunk)."""
    if stamp is None or not stamp.enabled or stamp.seq_transform == "none":
        return 1
    w = 2 ** stamp.resolved_levels(chunk)
    return w if w <= chunk else 1


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (len,) int32
    max_new_tokens: int = 32
    out_tokens: Optional[np.ndarray] = None
    latency_s: float = 0.0
    ttft_s: float = 0.0           # submit → first token
    preemptions: int = 0
    submit_t: float = 0.0
    obs_submit_t: float = 0.0     # the observability clock's submit stamp
    # "queued" until the request reaches exactly one terminal state:
    # "finished" | "failed" | "cancelled" | "rejected"; ``error`` says why
    # for failed and rejected ones; failed and cancelled requests keep
    # their partial generation in ``out_tokens``
    status: str = "queued"
    error: Optional[str] = None
    deadline_s: Optional[float] = None       # submit → finish budget
    ttft_deadline_s: Optional[float] = None  # submit → first-token budget


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8
    bucket: int = 128             # prompt bucket length (pad to this)
    max_seq: int = 256            # cache capacity
    eos_id: int = -1              # < 0 disables EOS stopping
    max_events: int = 4096        # event ring size (0 = unbounded)
    # quant-telemetry clip rate above which a quant_clip_alert event fires
    clip_alert_threshold: float = 0.05


@dataclasses.dataclass
class PagedEngineConfig:
    max_slots: int = 8            # decode batch width
    prefill_chunk: int = 128      # tokens per prefill chunk row
    max_seq: int = 256            # per-request length cap (table width)
    block_size: int = 16          # tokens per cache page
    num_hi_blocks: Optional[int] = None   # pool sizes; None = enough for
    num_lo_blocks: Optional[int] = None   # max_slots full-length requests
    eos_id: int = -1
    max_prefills: int = 2         # chunk spans per unified step (>= 1)
    step_mode: str = "unified"    # "unified" | "two_call"
    max_events: int = 4096        # event ring size (0 = unbounded)
    max_waiting: Optional[int] = None  # bounded waiting queue (None = ∞)
    shed_policy: str = "reject_newest"  # "reject_newest" | "shed_oldest"
    # consecutive zero-span steps before the watchdog fails the request at
    # the head of the line (0 disables)
    watchdog_steps: int = 8
    # on a NaN/Inf quarantine under fused STaMP, demote the engine to
    # reference execution on the weights kept for it
    demote_on_nan: bool = True
    preempt_watermark: float = 1.0  # SchedulerConfig.preempt_watermark
    prefix_caching: bool = True   # hash-addressed prompt page reuse
    clip_alert_threshold: float = 0.05


class _EngineBase:
    """What both engines share.

    A fused STaMP config prepares every fused site's weights to int8 once
    here, layer by layer (the packed input weights are not kept), and
    turns on the decode kernel for decode-shaped linears;
    ``params["layers"]`` may be an iterator, whose layers are released as
    soon as they are prepared, so a full-width model never holds its packed
    and prepared forms at once.  ``keep_raw`` keeps the packed weights
    beside the prepared ones, for a fused → reference demotion.  Runs on
    ``cuda`` unless ``device`` says otherwise; ``params`` must lie there.

    The observability surface is the reference's: ``metrics`` (a
    `MetricsRegistry` holding :attr:`STAT_KEYS` as counters, plus the
    port's :attr:`EXTRA_KEYS`), ``stats`` (a dict view of them), the
    ``events`` ring and the ``plan`` / ``dispatch`` / ``post`` phase timer.
    ``clock`` is the semantic time source (deadlines, ``ttft_s``,
    ``latency_s``), read at the reference's points: submit, the start and
    end of ``run``, each step's deadline check, a first token, a finish or
    other terminal state.  ``obs_clock`` stamps events and feeds the
    histograms: read twice a phase and once a submit, never by an event
    append, so observability never changes how often ``clock`` is read.

    ``device_dispatches`` counts step-function calls and ``recompiles`` the
    distinct step shape keys (chunk-row buckets) first seen: the port
    compiles nothing, so these are the reference's host-side fallback
    counts (its ``_compiled_keys``)."""

    STAT_KEYS = ("steps", "decode_tokens", "prefill_chunks", "preemptions",
                 "device_dispatches", "recompiles", "swap_bytes",
                 "finished", "failed", "cancelled", "rejected", "shed",
                 "deadline_misses", "nan_quarantines", "demotions",
                 "watchdog_trips", "stalled_steps", "swap_corruptions",
                 "prefix_cache_queries", "prefix_cache_hits",
                 "prefix_tokens_reused", "cow_copies")
    # the port's own counters beside the reference's
    EXTRA_KEYS = ("resumes", "nonfinite_logit_rows")

    def __init__(self, params: dict, cfg: ModelConfig,
                 serve: lm.ServeConfig, device=None,
                 clock: Optional[Callable[[], float]] = None,
                 obs_clock: Optional[Callable[[], float]] = None,
                 keep_raw: bool = False):
        self.device = resolve_device(device)
        self._clock = clock if clock is not None else time.perf_counter
        self._obs_clock = obs_clock if obs_clock is not None \
            else time.perf_counter
        self._obs_now = 0.0
        self._step_i = 0
        self.metrics = MetricsRegistry()
        for k in self.STAT_KEYS + self.EXTRA_KEYS:
            self.metrics.counter(k, help=f"engine {k.replace('_', ' ')}")
        self._timer = StepTimer(self.metrics, self._tick,
                                on_phase=self._on_phase)
        self.events: collections.deque = collections.deque()
        self._raw_params = None
        if serve.stamp is not None and serve.stamp.enabled and \
                serve.stamp.execution == "fused":
            if keep_raw:
                params = dict(params, layers=list(params["layers"]))
                self._raw_params = params
            params = lm.prepare_fused_weights(params, serve.stamp)
            serve = dataclasses.replace(serve, fused_decode_matmul=True)
        self.params = dict(params, layers=list(params["layers"]))
        self.cfg = cfg
        self.serve = serve
        self._uid = 0
        self._refresh_eligibility()

    def _refresh_eligibility(self) -> None:
        """Recompute the per-site fused / reference matrix for the current
        serve config and publish ``reference_fallback_sites``."""
        self.eligibility = lm.fused_site_matrix(self.cfg, self.serve.stamp)
        n_ref = sum(1 for c in self.eligibility.values()
                    if c["status"] == "reference")
        self.metrics.gauge(
            "reference_fallback_sites",
            help="linear sites running the reference (non-fused) path"
        ).set(n_ref)

    # -- observability core ------------------------------------------------
    def _init_events(self, max_events: int) -> None:
        self.events = collections.deque(
            maxlen=max_events if max_events > 0 else None)

    def _tick(self) -> float:
        """Read and cache the observability clock: event appends until the
        next tick share the cached stamp."""
        self._obs_now = self._obs_clock()
        return self._obs_now

    def _event(self, kind: str, uid: Optional[int] = None,
               dur: Optional[float] = None, phase: Optional[str] = None,
               **fields) -> None:
        self.events.append(Event(step=self._step_i, kind=kind, uid=uid,
                                 t=self._obs_now, dur=dur, phase=phase,
                                 fields=fields))

    def _on_phase(self, name: str, t0: float, dur: float) -> None:
        self.events.append(Event(step=self._step_i, kind="phase",
                                 t=t0, dur=dur, phase=name))

    def _inc(self, stat: str, n: float = 1) -> None:
        self.metrics.counter(stat).inc(n)

    @property
    def stats(self) -> Dict[str, int]:
        """Dict view of the registry counters plus the
        ``reference_fallback_sites`` gauge (a snapshot: mutate through the
        registry or :meth:`reset_stats`)."""
        out = {k: int(self.metrics.counter(k).value)
               for k in self.STAT_KEYS + self.EXTRA_KEYS}
        out["reference_fallback_sites"] = int(
            self.metrics.gauge("reference_fallback_sites").value)
        return out

    def reset_stats(self, keep: tuple = ("recompiles",),
                    clear_events: bool = False) -> None:
        """Zero every metric but ``keep``, optionally clearing the event
        ring (a benchmark's warmup / measure boundary)."""
        self.metrics.reset(exclude=keep)
        self._refresh_eligibility()
        self._refresh_derived_gauges()
        if clear_events:
            self.events.clear()

    def _refresh_derived_gauges(self) -> None:
        """Gauges recomputed from live state after a reset (the paged
        engine's prefix-cache gauges); the base has none."""

    def _observe_latency(self, name: str, seconds: float) -> None:
        self.metrics.histogram(name, help=f"request {name}").observe(
            max(seconds, 0.0))

    def _absorb_telemetry(self, raw) -> None:
        """Fold one step's quant-telemetry site dict into the registry:
        counters for the counts, gauges for the step's rates, and a
        ``quant_clip_alert`` event for a site over the threshold."""
        if not raw:
            return
        raw = dict(raw)
        router = raw.pop("moe_router", None)
        if router is not None:
            self._absorb_router_stats(router)
        summ = QS.summarize(raw)
        thresh = getattr(self.ecfg, "clip_alert_threshold", 0.05)
        for site, s in summ.items():
            lbl = {"site": site}
            for key in ("clipped", "saturated", "elems", "hi_tokens",
                        "tokens"):
                self.metrics.counter(
                    f"quant_{key}_total", labels=lbl,
                    help=f"quant telemetry: cumulative {key}").inc(s[key])
            for key in ("clip_rate", "sat_rate", "hi_coverage",
                        "scale_log2_range"):
                self.metrics.gauge(
                    f"quant_{key}", labels=lbl,
                    help=f"quant telemetry: last-step {key}").set(s[key])
            if s["clip_rate"] > thresh:
                self.metrics.counter(
                    "quant_clip_alerts", labels=lbl,
                    help="clip-rate threshold crossings").inc()
                self._event("quant_clip_alert", site=site,
                            clip_rate=s["clip_rate"], threshold=thresh)

    def _absorb_router_stats(self, router: dict) -> None:
        """Publish the MoE router's load counters: per-expert gauges, the
        cumulative dropped-token counter, the step's capacity occupancy and
        drop rate."""
        expert_tokens = np.asarray(router.get("expert_tokens", []),
                                   np.float64).reshape(-1)
        dropped = float(np.asarray(router.get("dropped_tokens", 0.0)))
        slots = float(np.asarray(router.get("capacity_slots", 0.0)))
        for i, n in enumerate(expert_tokens):
            self.metrics.gauge(
                "moe_expert_tokens", labels={"expert": str(i)},
                help="MoE router: tokens dispatched to this expert "
                     "(last step, summed over layers)").set(float(n))
        self.metrics.counter(
            "moe_dropped_tokens",
            help="MoE router: cumulative capacity-dropped tokens").inc(
            dropped)
        routed = float(expert_tokens.sum())
        self.metrics.gauge(
            "moe_capacity_occupancy",
            help="MoE router: kept tokens / capacity slots (last step)"
        ).set(routed / slots if slots > 0 else 0.0)
        total = routed + dropped
        self.metrics.gauge(
            "moe_drop_rate",
            help="MoE router: dropped / (kept + dropped) (last step)"
        ).set(dropped / total if total > 0 else 0.0)

    def _to_host(self, logits: tuple, telem) -> tuple:
        """The step's one device → host transfer: for each ``(n, V)``
        logits block its greedy ids and finite flags, then the telemetry
        scalars.  Returns ``([(ids, finite), ...], telemetry or None)`` and
        counts the non-finite rows."""
        parts = []
        for block in logits:
            parts.append(block.argmax(dim=-1).double())
            parts.append(torch.isfinite(block).all(dim=-1).double())
        layout = None
        if telem:
            layout, tparts = QS.flatten(telem)
            parts += tparts
        host = torch.cat(parts).cpu().numpy()
        out, i = [], 0
        for block in logits:
            n = block.shape[0]
            out.append((host[i:i + n].astype(np.int64),
                        host[i + n:i + 2 * n] > 0.5))
            i += 2 * n
        self._inc("nonfinite_logit_rows",
                  int(sum((~ok).sum() for _, ok in out)))
        return out, (QS.unflatten(layout, host[i:]) if layout else None)

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32,
               deadline_s: Optional[float] = None,
               ttft_deadline_s: Optional[float] = None) -> int:
        """Queue one request; returns its uid.  Malformed input raises
        here.  Deadlines are budgets in ``clock`` seconds from this call;
        the paged engine fails a request at the first planning step past
        its budget."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt: a request needs at least one "
                             "prompt token")
        if max_new_tokens <= 0:
            raise ValueError(f"max_new_tokens must be positive, got "
                             f"{max_new_tokens}")
        limit = self._max_prompt_len()
        if prompt.size > limit:
            raise ValueError(f"prompt length {prompt.size} exceeds the "
                             f"engine's limit of {limit} tokens")
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab_size:
            raise ValueError("prompt token ids outside the vocabulary")
        self._uid += 1
        req = Request(self._uid, prompt, max_new_tokens,
                      submit_t=self._clock(), obs_submit_t=self._tick(),
                      deadline_s=deadline_s,
                      ttft_deadline_s=ttft_deadline_s)
        self._event("submit", uid=req.uid, prompt_len=int(prompt.size))
        self._enqueue(req)
        return self._uid

    def _max_prompt_len(self) -> int:
        raise NotImplementedError

    def _enqueue(self, req: Request) -> None:
        raise NotImplementedError


class BucketedEngine(_EngineBase):
    """Lockstep slot batching over the contiguous cache (see the module
    docstring): the simple baseline beside the paged engine, and its
    numerics oracle.  The cache holds ``ecfg.max_seq`` tokens per slot."""

    def __init__(self, params: dict, cfg: ModelConfig,
                 serve: lm.ServeConfig, ecfg: Optional[EngineConfig] = None,
                 device=None, clock: Optional[Callable[[], float]] = None,
                 obs_clock: Optional[Callable[[], float]] = None):
        super().__init__(params, cfg, serve, device, clock=clock,
                         obs_clock=obs_clock)
        self.ecfg = ecfg if ecfg is not None else EngineConfig()
        self._init_events(self.ecfg.max_events)
        self.serve = dataclasses.replace(self.serve,
                                         cache_capacity=self.ecfg.max_seq)
        self._collect = lm._collect_telemetry(self.serve)
        self.queue: List[Request] = []

    def _max_prompt_len(self) -> int:
        # one position stays free for the first generated token's K/V
        return min(self.ecfg.bucket, self.ecfg.max_seq - 1)

    def _enqueue(self, req: Request) -> None:
        self.queue.append(req)

    @torch.inference_mode()
    def run(self) -> List[Request]:
        """Drain the queue in batches of ``max_batch``; returns the
        finished requests."""
        done: List[Request] = []
        while self.queue:
            batch = self.queue[:self.ecfg.max_batch]
            self.queue = self.queue[self.ecfg.max_batch:]
            done.extend(self._run_batch(batch))
        return done

    def _run_batch(self, reqs: List[Request]) -> List[Request]:
        t0 = self._clock()
        e, b = self.ecfg, len(reqs)
        self._step_i += 1
        self._inc("steps")
        with self._timer.phase("plan"):
            prompts = np.zeros((b, e.bucket), np.int32)
            lens = np.zeros((b,), np.int32)
            for i, r in enumerate(reqs):
                prompts[i, :r.prompt.size] = r.prompt          # right-pad
                lens[i] = r.prompt.size
            for r in reqs:
                self._event("admit", uid=r.uid)
                self._observe_latency("queue_wait_s",
                                      self._obs_now - r.obs_submit_t)
        with self._timer.phase("dispatch"):
            out = lm.prefill(
                self.params, torch.from_numpy(prompts).to(self.device),
                self.cfg, self.serve,
                last_pos=torch.from_numpy(lens - 1).to(self.device))
            logits, cache = out[:2]
            self._inc("device_dispatches")
            self._inc("prefill_chunks", b)
            max_new = min(max(r.max_new_tokens for r in reqs),
                          e.max_seq - int(lens.max()))
            outs = np.zeros((b, max_new), np.int32)
            tok = logits.argmax(dim=-1).to(torch.int32)
            # waits for the prefill, so the first-token stamp measures it
            ((tok_host, _),), telem = self._to_host(
                (logits,), out[2] if self._collect else None)
        if telem is not None:
            self._absorb_telemetry(telem)
        t_first = self._clock()
        for r in reqs:
            r.ttft_s = t_first - r.submit_t
            self._event("first_token", uid=r.uid)
            self._observe_latency("ttft_s", self._obs_now - r.obs_submit_t)
        alive = np.ones(b, bool)
        pos = torch.from_numpy(lens).to(self.device)
        for step in range(max_new):
            outs[:, step] = np.where(alive, tok_host, 0)
            if e.eos_id >= 0:
                alive &= outs[:, step] != e.eos_id
                if not alive.any():
                    outs = outs[:, :step + 1]
                    break
            with self._timer.phase("dispatch"):
                self._step_i += 1
                self._inc("steps")
                logits, cache = lm.decode_step(self.params, cache, tok,
                                               pos + step, self.cfg,
                                               self.serve)
                self._inc("device_dispatches")
                tok = logits.argmax(dim=-1).to(torch.int32)
                ((tok_host, _),), _ = self._to_host((logits,), None)
            self._inc("decode_tokens", int(alive.sum()))
        dt = self._clock() - t0
        self._tick()
        for i, r in enumerate(reqs):
            r.out_tokens = outs[i][:r.max_new_tokens]
            r.latency_s = dt
            r.status = "finished"
            self._inc("finished")
            self._event("finish", uid=r.uid)
            self._observe_latency("latency_s",
                                  self._obs_now - r.obs_submit_t)
        return reqs


class PagedServingEngine(_EngineBase):
    """Continuous batching over the block-paged cache (see the module
    docstring).  ``fault`` is a seeded :class:`FaultPlan` the allocator,
    the swap path and the token pick consult.  ``run()`` returns every
    submitted request in exactly one terminal state and never raises for a
    request's own fault."""

    def __init__(self, params: dict, cfg: ModelConfig,
                 serve: lm.ServeConfig,
                 ecfg: Optional[PagedEngineConfig] = None, device=None,
                 fault: Optional[FaultPlan] = None,
                 clock: Optional[Callable[[], float]] = None,
                 obs_clock: Optional[Callable[[], float]] = None):
        # an enc-dec stack is refused before anything is prepared or
        # allocated (the reference's refusal comes from init_paged_cache)
        lm.refuse_paged(cfg)
        e = ecfg if ecfg is not None else PagedEngineConfig()
        if e.shed_policy not in ("reject_newest", "shed_oldest"):
            raise ValueError(f"unknown shed_policy {e.shed_policy!r}")
        if e.step_mode not in ("unified", "two_call"):
            raise ValueError(f"unknown step_mode {e.step_mode!r}")
        # the weights reference execution needs are kept only where a
        # demotion can happen: fused STaMP under the numerics guard
        super().__init__(params, cfg, serve, device, clock=clock,
                         obs_clock=obs_clock,
                         keep_raw=serve.numerics_guard and e.demote_on_nan)
        self.ecfg = e
        self.fault = fault
        quant = self.serve.kv
        num_hi = quant.num_hi if quant.quantized else 0
        if num_hi % e.block_size:
            raise ValueError("num_hi must be a multiple of block_size")
        hi_per_seq = num_hi // e.block_size
        lo_per_seq = -(-(e.max_seq - num_hi) // e.block_size)
        n_hi = e.num_hi_blocks if e.num_hi_blocks is not None \
            else e.max_slots * hi_per_seq + 1
        n_lo = e.num_lo_blocks if e.num_lo_blocks is not None \
            else e.max_slots * lo_per_seq + 1
        self.pcfg = PKV.PagedCacheConfig(
            block_size=e.block_size, num_lo_blocks=n_lo,
            num_hi_blocks=max(n_hi, 1), max_blocks_per_seq=lo_per_seq,
            quant=quant)
        self.serve = dataclasses.replace(self.serve, paged=self.pcfg)
        # attention layers read and write the page pools, Mamba layers the
        # slot-dense SSM state pool (its null slot is row max_slots)
        specs = cfg.layer_specs()
        self._has_attn = any(s.mixer == "attn" for s in specs)
        self._has_mamba = any(s.mixer == "mamba" for s in specs)
        self.pools = lm.init_paged_cache(cfg, self.pcfg, device=self.device,
                                         num_slots=e.max_slots)
        unified = e.step_mode == "unified"
        # prefix reuse skips prefill for cached tokens, which a Mamba
        # layer cannot (its state must advance through every token); a
        # pure-SSM stack has no pages to share at all
        self._prefix_on = bool(e.prefix_caching and self._has_attn
                               and not self._has_mamba)
        self.sched = Scheduler(
            SchedulerConfig(
                max_slots=e.max_slots, prefill_chunk=e.prefill_chunk,
                max_prefills=max(e.max_prefills, 1) if unified else 1,
                transform_window=_transform_window(
                    self.serve.stamp, e.prefill_chunk) if unified else 1,
                state_bytes_per_slot=PKV.ssm_state_bytes_per_slot(
                    self.pools),
                needs_kv_pages=self._has_attn,
                preempt_watermark=e.preempt_watermark,
                prefix_caching=self._prefix_on),
            self.pcfg, swap_out=self._swap_out, swap_in=self._swap_in,
            cow=self._cow_copy, on_prefix=self._on_prefix_lookup)
        if fault is not None:
            # injected exhaustion runs through the real preemption paths
            self.sched.alloc.fault = fault.exhausted
        self._requests: Dict[int, Request] = {}
        self._init_events(e.max_events)
        self._stall = 0                         # consecutive zero-span steps
        self._swap_failed: List[tuple] = []     # (sreq, error) from _swap_in
        self._terminal_done: List[Request] = []
        self._demoted = False
        mp = max(e.max_prefills, 1) if unified else 1
        buckets, b = {0, mp}, 1
        while b < mp:
            buckets.add(b)
            b *= 2
        self._npf_buckets = sorted(buckets)
        self._build_step_fns()
        self._refresh_prefix_gauges()

    # -- prefix caching ----------------------------------------------------
    def _on_prefix_lookup(self, sreq: SchedRequest, match) -> None:
        self._inc("prefix_cache_queries")
        if match is None:
            return
        self._inc("prefix_cache_hits")
        self._inc("prefix_tokens_reused", match.matched)
        self._event("prefix_hit", uid=sreq.uid, matched=match.matched,
                    pages=len(match.hi_pages) + len(match.lo_pages))

    def _cow_copy(self, sreq: SchedRequest, pool: str, src: int,
                  dst: int) -> None:
        PKV.copy_page(self.pools, pool, src, dst)
        self._inc("cow_copies")
        self._event("cow", uid=sreq.uid, pool=pool, src=src, dst=dst)

    def _refresh_prefix_gauges(self) -> None:
        """The prefix-cache gauges, recomputed from the allocator's live
        state (never carried, so a reset cannot zero them)."""
        cs = self.sched.alloc.cache_stats()
        q = self.metrics.counter("prefix_cache_queries").value
        h = self.metrics.counter("prefix_cache_hits").value
        self.metrics.gauge(
            "prefix_cache_hit_rate",
            help="prefix cache: hits / lookups").set(h / q if q else 0.0)
        self.metrics.gauge(
            "kv_pages_shared",
            help="pages currently referenced by 2+ requests").set(
            cs["kv_pages_shared"])
        self.metrics.gauge(
            "sink_pages_pinned",
            help="hi-precision (int8 sink) pages cached AND referenced — "
                 "the mixed-precision cost a shared prefix pins for every "
                 "child").set(cs["sink_pages_pinned"])
        self.metrics.gauge(
            "prefix_cached_pages",
            help="pages registered in the prefix cache").set(
            cs["cached_pages"])

    def _refresh_derived_gauges(self) -> None:
        self._refresh_prefix_gauges()

    @property
    def stats(self) -> Dict[str, int]:
        out = _EngineBase.stats.fget(self)
        g = self.metrics.gauge
        out["prefix_cache_hit_rate"] = float(
            g("prefix_cache_hit_rate").value)
        out["kv_pages_shared"] = int(g("kv_pages_shared").value)
        out["sink_pages_pinned"] = int(g("sink_pages_pinned").value)
        out["prefix_cached_pages"] = int(g("prefix_cached_pages").value)
        return out

    def _build_step_fns(self) -> None:
        """Reset the shape keys seen and the telemetry switch for the
        current serve config (at construction and after a demotion)."""
        self._compiled_keys: set = set()
        self._collect = lm._collect_telemetry(self.serve)

    def compile_count(self) -> int:
        """Distinct unified-step shape keys (chunk-row buckets) seen since
        the step functions were last built."""
        return len(self._compiled_keys)

    # -- requests ----------------------------------------------------------
    def _max_prompt_len(self) -> int:
        return self.ecfg.max_seq - 1

    def _capacity_reason(self, req: Request) -> Optional[str]:
        """None if the request could ever run alone on this engine, else
        why not: its page demand at the deepest position the scheduler
        reserves (``prompt_len + gen - 1``), less the fully shared pages of
        a cached prefix, against the whole pools."""
        if not self._has_attn:
            return None              # pure SSM: slots are the only capacity
        plen = int(req.prompt.shape[0])
        gen = min(req.max_new_tokens, self.ecfg.max_seq - plen)
        nh, nl = PKV.pages_needed(plen + gen - 1, self.pcfg)
        cap_hi, cap_lo = self.sched.alloc.capacity()
        if nh > cap_hi or nl > cap_lo:
            matched = self.sched.probe_prefix(req.prompt)
            bs = self.pcfg.block_size
            ch, cl = PKV.pages_needed(matched // bs * bs, self.pcfg)
            if nh - ch > cap_hi or nl - cl > cap_lo:
                return (f"capacity-infeasible: needs {nh} hi + {nl} lo "
                        f"pages at peak but the pools hold only {cap_hi} "
                        f"hi + {cap_lo} lo — the request could never run "
                        f"even alone")
        return None

    def _enqueue(self, req: Request) -> None:
        self._requests[req.uid] = req
        reason = self._capacity_reason(req)
        if reason is not None:
            self._terminate(req, REJECTED, reason, stat="rejected",
                            kind="reject")
            return
        e = self.ecfg
        if e.max_waiting is not None and \
                len(self.sched.waiting) >= e.max_waiting:
            if e.shed_policy == "shed_oldest":
                # shed a queued request that has not run at all (a
                # preempted one holds real progress)
                fresh = [r for r in self.sched.waiting if r.swapped is None
                         and r.pos == 0 and not r.generated]
                if fresh:
                    victim = fresh[0]
                    self.sched.cancel(victim.uid, state=REJECTED,
                                      error="shed: waiting queue full")
                    self._terminate(self._requests[victim.uid], REJECTED,
                                    "shed: waiting queue full", stat="shed",
                                    kind="shed", sreq=victim)
                else:
                    self._terminate(req, REJECTED,
                                    "shed: waiting queue full",
                                    stat="shed", kind="shed")
                    return
            else:                    # reject_newest
                self._terminate(req, REJECTED,
                                f"waiting queue full "
                                f"({e.max_waiting} requests)",
                                stat="shed", kind="shed")
                return
        self.sched.submit(SchedRequest(uid=req.uid, prompt=req.prompt,
                                       max_new_tokens=req.max_new_tokens,
                                       arrival=req.uid))

    def _terminate(self, req: Request, status: str, error: Optional[str],
                   stat: str, kind: str,
                   sreq: Optional[SchedRequest] = None) -> None:
        """Move one request to a terminal state outside the normal finish
        (reject / shed / cancel / fail) and queue it for ``run``'s
        result."""
        req.status = status
        req.error = error
        if req.out_tokens is None:
            gen = sreq.generated[:sreq.max_new_tokens] if sreq else []
            req.out_tokens = np.asarray(gen, np.int32)
        if sreq is not None:
            req.preemptions = sreq.preemptions
        req.latency_s = self._clock() - req.submit_t
        self._inc(stat)
        if error:
            self._event(kind, uid=req.uid, error=error)
        else:
            self._event(kind, uid=req.uid)
        self._observe_latency("latency_s", self._obs_now - req.obs_submit_t)
        self._terminal_done.append(req)

    def _swap_out(self, sreq: SchedRequest) -> None:
        # the slot is still assigned (the scheduler swaps before it frees
        # it), so a Mamba layer's state rides along with the pages
        sreq.swapped = PKV.extract_pages(self.pools, sreq.hi_pages,
                                         sreq.lo_pages, slot=sreq.slot)
        self._event("preempt", uid=sreq.uid)
        self._inc("preemptions")
        self._inc("swap_bytes", PKV.swapped_bytes(sreq.swapped))

    def _swap_in(self, sreq: SchedRequest) -> None:
        swapped = sreq.swapped
        if self.fault is not None and self.fault.corrupt_swap(sreq.uid):
            swapped = corrupt_swapped(swapped, self.fault.seed)
            self._event("fault_corrupt", uid=sreq.uid)
        try:
            # sreq.slot is the new placement: the SSM state restores there
            PKV.insert_pages(self.pools, swapped, sreq.hi_pages,
                             sreq.lo_pages, slot=sreq.slot)
        except PKV.SwapCorruption as exc:
            # verified before anything was written: the scheduler finishes
            # placing the request and _step fails it right after planning
            self._swap_failed.append((sreq, str(exc)))
            return
        self._inc("resumes")
        self._event("resume", uid=sreq.uid)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def run(self) -> List[Request]:
        """Drain the engine.  Every submitted request comes back in exactly
        one terminal state; a request's own problem (rejection, deadline
        miss, swap corruption, NaN quarantine, livelock) fails that request
        and never raises out of ``run``."""
        t0 = self._clock()
        done: List[Request] = []
        self._drain_terminal(done)
        while self.sched.has_work():
            self._step(done)
            self._drain_terminal(done)
        dt = self._clock() - t0
        for r in done:
            r.latency_s = r.latency_s or dt
        return done

    def _drain_terminal(self, done: List[Request]) -> None:
        if self._terminal_done:
            done.extend(self._terminal_done)
            self._terminal_done = []

    def cancel(self, uid: int) -> bool:
        """Terminate one request wherever it is (queued, prefilling,
        decoding or preempted), releasing exactly what it holds; partial
        tokens stay on the Request.  False for an unknown or terminal
        uid."""
        sreq = self.sched.cancel(uid)
        if sreq is None:
            return False
        self._terminate(self._requests[uid], CANCELLED, None,
                        stat="cancelled", kind="cancel", sreq=sreq)
        return True

    def request(self, uid: int) -> Optional[Request]:
        """The Request record of a uid (terminal or not)."""
        return self._requests.get(uid)

    def _fail(self, sreq: SchedRequest, error: str,
              kind: str = "fail") -> None:
        """Release one request's resources and mark it failed; everyone
        else keeps running."""
        self.sched.fail(sreq, error)
        self._terminate(self._requests[sreq.uid], "failed", error,
                        stat="failed", kind=kind, sreq=sreq)

    def _check_deadlines(self) -> None:
        """Fail every request past its total or TTFT budget before the step
        plans, so its slot and pages go to requests that can still meet
        theirs (one ``clock`` read a step)."""
        now = self._clock()
        for sreq in list(self.sched.active) + list(self.sched.waiting):
            req = self._requests[sreq.uid]
            waited = now - req.submit_t
            miss = None
            if req.deadline_s is not None and waited > req.deadline_s:
                miss = (f"deadline miss: {waited:.3f}s elapsed > "
                        f"{req.deadline_s:.3f}s total budget")
            elif req.ttft_deadline_s is not None and not sreq.generated \
                    and waited > req.ttft_deadline_s:
                miss = (f"deadline miss: no first token after "
                        f"{waited:.3f}s > {req.ttft_deadline_s:.3f}s "
                        f"TTFT budget")
            if miss is not None:
                self._inc("deadline_misses")
                self._event("deadline_miss", uid=sreq.uid)
                self._fail(sreq, miss)

    def _watchdog(self, progress: bool) -> None:
        """Livelock backstop: after ``watchdog_steps`` consecutive steps
        with work but no span, fail the request at the head of the line."""
        if progress:
            self._stall = 0
            return
        if not self.sched.has_work():
            return
        self._stall += 1
        self._inc("stalled_steps")
        n = self.ecfg.watchdog_steps
        if n <= 0 or self._stall < n:
            return
        self._stall = 0
        self._inc("watchdog_trips")
        blockers = sorted(self.sched.waiting + self.sched.active,
                          key=lambda r: (r.arrival, r.uid))
        if blockers:
            self._fail(blockers[0],
                       f"watchdog: no scheduling progress for {n} "
                       f"consecutive steps", kind="watchdog")

    # -- numerics guard ----------------------------------------------------
    def _next_token(self, sreq: SchedRequest, tok: int, finite: bool) -> bool:
        """Append one span's greedy token behind the NaN/Inf guard; False
        when the request was quarantined instead.  An injected NaN row
        reads as non-finite with greedy id 0 (the argmax of an all-NaN
        row)."""
        if self.fault is not None and \
                self.fault.nan_logits(sreq.uid, len(sreq.generated)):
            tok, finite = 0, False
            self._event("fault_nan", uid=sreq.uid)
        if self.serve.numerics_guard and not finite:
            self._quarantine(sreq, f"non-finite logits at generated index "
                                   f"{len(sreq.generated)}")
            return False
        sreq.generated.append(int(tok))
        return True

    def _quarantine(self, sreq: SchedRequest, error: str) -> None:
        self._inc("nan_quarantines")
        self._event("nan_quarantine", uid=sreq.uid)
        self._fail(sreq, error)
        self._maybe_demote()

    def _maybe_demote(self) -> None:
        """Fused → reference degradation after a NaN quarantine under fused
        STaMP: the engine continues on the packed weights kept for it, with
        reference execution (no STaMP kernels, no decode kernel; the cache
        attention is left as configured, as in the reference).  Once per
        engine; the cache pages are kept."""
        st = self.serve.stamp
        if (not self.ecfg.demote_on_nan or self._demoted or st is None
                or not st.enabled or st.execution != "fused"
                or self._raw_params is None):
            return
        self._demoted = True
        self.params = self._raw_params
        self._raw_params = None
        self.serve = dataclasses.replace(
            self.serve, stamp=dataclasses.replace(st, execution="reference"),
            fused_decode_matmul=False)
        self._build_step_fns()
        self._refresh_eligibility()
        self._refresh_prefix_gauges()
        self._inc("demotions")
        self._event("demote", to="reference")

    # -- one step ----------------------------------------------------------
    def _tables_np(self, sreqs: List[SchedRequest]) -> tuple:
        e, pc = self.ecfg, self.pcfg
        ht = np.zeros((e.max_slots, max(pc.hi_blocks_per_seq, 1)), np.int32)
        lt = np.zeros((e.max_slots, pc.max_blocks_per_seq), np.int32)
        for sreq in sreqs:
            if sreq.slot < 0:
                continue
            ht[sreq.slot, :len(sreq.hi_pages)] = sreq.hi_pages
            lt[sreq.slot, :len(sreq.lo_pages)] = sreq.lo_pages
        if pc.hi_blocks_per_seq == 0:
            ht = ht[:, :0]
        return ht, lt

    def _write_target(self, sreq: SchedRequest, pos: int) -> tuple:
        is_hi, pidx, off = PKV.token_page_index(pos, self.pcfg)
        page = (sreq.hi_pages if is_hi else sreq.lo_pages)[pidx]
        return page, off, is_hi

    def _bucket_npf(self, n: int) -> int:
        return next(b for b in self._npf_buckets if b >= n)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _step(self, done: List[Request]) -> None:
        self._step_i += 1
        self._inc("steps")
        with self._timer.phase("plan"):
            if self.fault is not None:
                self.fault.begin_step(self._step_i)
                if self.fault.exhausted():
                    self._event("fault_exhaust")
                if self.fault.flush_prefix():
                    dropped = self.sched.alloc.flush_cache()
                    self._event("fault_prefix_flush", dropped=dropped)
            self._check_deadlines()
            plan = self.sched.plan_step()
            for sreq in plan.admitted:
                self._event("admit", uid=sreq.uid)
                req = self._requests.get(sreq.uid)
                if req is not None:
                    self._observe_latency("queue_wait_s",
                                          self._obs_now - req.obs_submit_t)
            if self._swap_failed:
                # a swap-in refused its checksum while the scheduler placed
                # it: fail it and drop it from this step's spans
                for sreq, msg in self._swap_failed:
                    self._inc("swap_corruptions")
                    self._fail(sreq, msg, kind="swap_corrupt")
                self._swap_failed = []
                plan.prefills = [w for w in plan.prefills
                                 if w.sreq.state == PREFILLING]
                plan.decode = [r for r in plan.decode if r.state == RUNNING]

        progress = bool(plan.prefills or plan.decode)
        if self.ecfg.step_mode == "two_call":
            if plan.prefills:
                self._run_prefill_chunk(plan.prefills[0], done)
            if plan.decode:
                self._run_decode(plan.decode, done)
        elif progress:
            self._run_unified(plan, done)
        self._watchdog(progress)
        self._publish_load()

    def _publish_load(self) -> None:
        """Per-step occupancy gauges from the scheduler and allocator."""
        for name, v in self.sched.load().items():
            self.metrics.gauge(f"sched_{name}",
                               help=f"scheduler {name}").set(v)
        self._refresh_prefix_gauges()

    def _first_token(self, sreq: SchedRequest, tok: int, finite: bool,
                     done: List[Request]) -> None:
        """A final prefill chunk's token: the request starts decoding."""
        if not self._next_token(sreq, tok, finite):
            return                     # quarantined, resources released
        sreq.state = RUNNING
        req = self._requests[sreq.uid]
        req.ttft_s = self._clock() - req.submit_t
        self._event("first_token", uid=sreq.uid)
        self._observe_latency("ttft_s", self._obs_now - req.obs_submit_t)
        self._maybe_finish(sreq, done)

    def _run_unified(self, plan, done: List[Request]) -> None:
        """Build the step's ragged batch on the host and run it as one
        forward: ``n_pf`` chunk rows (bucketed; unused rows are null-page
        dummies) + the decode slot array."""
        e = self.ecfg
        c_len, s = e.prefill_chunk, e.max_slots
        works = plan.prefills
        n_pf = self._bucket_npf(len(works))
        with self._timer.phase("dispatch"):
            pf_tokens = np.zeros((n_pf, c_len), np.int32)
            pf_start = np.zeros((n_pf,), np.int32)
            pf_length = np.zeros((n_pf,), np.int32)
            pf_last = np.zeros((n_pf,), np.int32)
            pf_first = np.zeros((n_pf,), bool)
            # dummy chunk rows scatter their SSM state to the null slot
            pf_slots = np.full((n_pf,), s, np.int32)
            pages = np.zeros((n_pf * c_len + s,), np.int32)
            offs = np.zeros((n_pf * c_len + s,), np.int32)
            ishi = np.zeros((n_pf * c_len + s,), bool)
            for i, w in enumerate(works):
                valid = w.end - w.start
                pf_tokens[i, :valid] = w.sreq.prompt[w.start:w.end]
                pf_start[i], pf_length[i] = w.start, w.end
                pf_last[i] = valid - 1
                pf_first[i] = w.start == 0
                pf_slots[i] = w.sreq.slot
                for t in range(valid if self._has_attn else 0):
                    pages[i * c_len + t], offs[i * c_len + t], \
                        ishi[i * c_len + t] = self._write_target(
                            w.sreq, w.start + t)
            dec_tokens = np.zeros((s,), np.int32)
            dec_pos = np.zeros((s,), np.int32)
            dec_active = np.zeros((s,), bool)
            base = n_pf * c_len
            for sreq in plan.decode:
                dec_tokens[sreq.slot] = sreq.generated[-1]
                dec_pos[sreq.slot] = sreq.pos
                dec_active[sreq.slot] = True
                if self._has_attn:
                    pages[base + sreq.slot], offs[base + sreq.slot], \
                        ishi[base + sreq.slot] = self._write_target(
                            sreq, sreq.pos)
            ht_np, lt_np = self._tables_np([w.sreq for w in works]
                                           + plan.decode)
            pf_ht = np.zeros((n_pf, ht_np.shape[1]), np.int32)
            pf_lt = np.zeros((n_pf, lt_np.shape[1]), np.int32)
            for i, w in enumerate(works):
                pf_ht[i], pf_lt[i] = ht_np[w.sreq.slot], lt_np[w.sreq.slot]
            if n_pf not in self._compiled_keys:
                self._compiled_keys.add(n_pf)
                self._inc("recompiles")
            dev = self._dev
            out = lm.paged_unified_step(
                self.params, self.pools, dev(pf_tokens), dev(pf_start),
                dev(pf_length), dev(pf_last), dev(dec_tokens), dev(dec_pos),
                dev(np.concatenate([pf_ht, ht_np])),
                dev(np.concatenate([pf_lt, lt_np])), dev(pages), dev(offs),
                dev(ishi), self.cfg, self.serve, pf_first=dev(pf_first),
                pf_slots=dev(pf_slots), dec_active=dev(dec_active))
            self._inc("device_dispatches")
            ((pf_next, pf_ok), (dec_next, dec_ok)), telem = self._to_host(
                out[:2], out[3] if self._collect else None)
        if telem is not None:
            self._absorb_telemetry(telem)

        with self._timer.phase("post"):
            for i, w in enumerate(works):
                sreq = w.sreq
                try:
                    sreq.pos = w.end
                    # completed prompt pages become addressable for later
                    # arrivals (before a finish can release them)
                    self.sched.register_prefix(sreq)
                    self._inc("prefill_chunks")
                    self._event("prefill_chunk", uid=sreq.uid,
                                start=w.start, end=w.end)
                    if w.end == sreq.prompt_len:
                        self._first_token(sreq, pf_next[i], pf_ok[i], done)
                except Exception as exc:  # noqa: BLE001 — isolation boundary
                    self._fail(sreq,
                               f"prefill postprocessing error: {exc!r}")
            if plan.decode:
                self._event("decode",
                            uids=tuple(sorted(r.uid for r in plan.decode)))
                for sreq in plan.decode:
                    try:
                        sreq.pos += 1          # last token is now cached
                        if not self._next_token(sreq, dec_next[sreq.slot],
                                                dec_ok[sreq.slot]):
                            continue
                        self._inc("decode_tokens")
                        self._maybe_finish(sreq, done)
                    except Exception as exc:   # noqa: BLE001
                        self._fail(sreq,
                                   f"decode postprocessing error: {exc!r}")

    # -- two_call mode -------------------------------------------------------
    def _run_prefill_chunk(self, work: PrefillWork,
                           done: List[Request]) -> None:
        """One prefill chunk of one request (`lm.paged_prefill_chunk`)."""
        e = self.ecfg
        sreq, start, end = work.sreq, work.start, work.end
        valid = end - start
        with self._timer.phase("dispatch"):
            chunk = np.zeros((1, e.prefill_chunk), np.int32)
            chunk[0, :valid] = sreq.prompt[start:end]
            pages = np.zeros((e.prefill_chunk,), np.int32)
            offs = np.zeros((e.prefill_chunk,), np.int32)
            ishi = np.zeros((e.prefill_chunk,), bool)
            for i in range(valid if self._has_attn else 0):
                pages[i], offs[i], ishi[i] = self._write_target(sreq,
                                                                start + i)
            ht, lt = self._tables_np([sreq])
            slot = slice(sreq.slot, sreq.slot + 1)
            out = lm.paged_prefill_chunk(
                self.params, self.pools, self._dev(chunk), start,
                self._dev(ht[slot]), self._dev(lt[slot]), self._dev(pages),
                self._dev(offs), self._dev(ishi), valid - 1, self.cfg,
                self.serve, first=start == 0, slot=sreq.slot)
            self._inc("device_dispatches")
            ((nxt, ok),), telem = self._to_host(
                out[:1], out[2] if self._collect else None)
        if telem is not None:
            self._absorb_telemetry(telem)
        with self._timer.phase("post"):
            sreq.pos = end
            self.sched.register_prefix(sreq)
            self._inc("prefill_chunks")
            self._event("prefill_chunk", uid=sreq.uid, start=start, end=end)
            if end == sreq.prompt_len:
                self._first_token(sreq, nxt[0], ok[0], done)

    def _run_decode(self, running: List[SchedRequest],
                    done: List[Request]) -> None:
        """The decode slot array (`lm.paged_decode_step`)."""
        s = self.ecfg.max_slots
        with self._timer.phase("dispatch"):
            tokens = np.zeros((s,), np.int32)
            positions = np.zeros((s,), np.int32)
            pages = np.zeros((s,), np.int32)
            offs = np.zeros((s,), np.int32)
            ishi = np.zeros((s,), bool)
            active = np.zeros((s,), bool)
            for sreq in running:
                tokens[sreq.slot] = sreq.generated[-1]
                positions[sreq.slot] = sreq.pos
                active[sreq.slot] = True
                if self._has_attn:
                    pages[sreq.slot], offs[sreq.slot], ishi[sreq.slot] = \
                        self._write_target(sreq, sreq.pos)
            ht, lt = self._tables_np(running)
            dev = self._dev
            logits, _ = lm.paged_decode_step(
                self.params, self.pools, dev(tokens), dev(positions),
                dev(ht), dev(lt), dev(pages), dev(offs), dev(ishi), self.cfg,
                self.serve, dev(active))
            self._inc("device_dispatches")
            ((nxt, ok),), _ = self._to_host((logits,), None)
        with self._timer.phase("post"):
            self._event("decode",
                        uids=tuple(sorted(r.uid for r in running)))
            for sreq in running:
                sreq.pos += 1                  # last token is now cached
                if not self._next_token(sreq, nxt[sreq.slot],
                                        ok[sreq.slot]):
                    continue
                self._inc("decode_tokens")
                self._maybe_finish(sreq, done)

    def _maybe_finish(self, sreq: SchedRequest, done: List[Request]) -> None:
        eos = self.ecfg.eos_id
        hit_eos = eos >= 0 and sreq.generated and sreq.generated[-1] == eos
        cap = min(sreq.max_new_tokens, self.ecfg.max_seq - sreq.prompt_len)
        if hit_eos or len(sreq.generated) >= cap:
            req = self._requests[sreq.uid]
            req.out_tokens = np.asarray(sreq.generated[:sreq.max_new_tokens],
                                        np.int32)
            req.latency_s = self._clock() - req.submit_t
            req.preemptions = sreq.preemptions
            req.status = "finished"
            self.sched.finish(sreq)
            self._inc("finished")
            self._event("finish", uid=sreq.uid)
            self._observe_latency("latency_s",
                                  self._obs_now - req.obs_submit_t)
            done.append(req)


# the reference's name for the bucketed engine
ServingEngine = BucketedEngine

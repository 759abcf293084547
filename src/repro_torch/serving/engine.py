"""Serving engines (the port of ``repro.serving.engine``): lockstep bucketed
batching over the contiguous mixed-precision cache, and continuous batching
over the block-paged one in its unified step mode.  Both share one request
API (``submit`` → ``run`` → finished :class:`Request` s with tokens, TTFT
and latency) and the fused-weight preparation, in :class:`_EngineBase`.

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
match), and plans up to ``max_prefills`` prefill chunks plus the decode
slot array.  The whole step then runs as ONE forward,
`lm.paged_unified_step`, with the chunk-row count bucketed to 0, 1, 2, 4, …
``max_prefills`` so the step sees a fixed set of shapes.  Greedy sampling;
``stats`` is a plain dict of counters.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.serving import paged_kvcache as PKV
from repro_torch.serving.scheduler import (RUNNING, SchedRequest, Scheduler,
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
    status: str = "queued"        # finished | rejected
    error: Optional[str] = None


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8
    bucket: int = 128             # prompt bucket length (pad to this)
    max_seq: int = 256            # cache capacity
    eos_id: int = -1              # < 0 disables EOS stopping


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
    prefix_caching: bool = True   # hash-addressed prompt page reuse


STAT_KEYS = ("steps", "decode_tokens", "prefill_chunks", "preemptions",
             "resumes", "swap_bytes", "finished", "rejected",
             "prefix_cache_queries", "prefix_cache_hits",
             "prefix_tokens_reused", "cow_copies", "nonfinite_logit_rows")


class _EngineBase:
    """What both engines share: a fused STaMP config prepares every fused
    site's weights to int8 once here, layer by layer (the packed input
    weights are not kept), and turns on the decode kernel for
    decode-shaped linears; ``params["layers"]`` may be an iterator, whose
    layers are released as soon as they are prepared, so a full-width model
    never holds its packed and prepared forms at once.  Then the request
    queue (``submit``) and the ``stats`` counters.  Runs on ``cuda`` unless
    ``device`` says otherwise; ``params`` must lie there."""

    def __init__(self, params: dict, cfg: ModelConfig,
                 serve: lm.ServeConfig, device=None):
        self.device = resolve_device(device)
        if serve.stamp is not None and serve.stamp.enabled and \
                serve.stamp.execution == "fused":
            params = lm.prepare_fused_weights(params, serve.stamp)
            serve = dataclasses.replace(serve, fused_decode_matmul=True)
        self.params = dict(params, layers=list(params["layers"]))
        self.cfg = cfg
        self.serve = serve
        self.stats: Dict[str, int] = {k: 0 for k in STAT_KEYS}
        self._uid = 0

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32) -> int:
        """Queue one request; returns its uid.  Malformed input raises
        here."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens <= 0:
            raise ValueError(f"max_new_tokens must be positive, got "
                             f"{max_new_tokens}")
        limit = self._max_prompt_len()
        if prompt.size > limit:
            raise ValueError(f"prompt length {prompt.size} exceeds the "
                             f"engine's limit of {limit}")
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab_size:
            raise ValueError("prompt token ids outside the vocabulary")
        self._uid += 1
        self._enqueue(Request(self._uid, prompt, max_new_tokens,
                              submit_t=time.perf_counter()))
        return self._uid

    def _count_nonfinite(self, *logits: torch.Tensor) -> None:
        bad = ~torch.isfinite(torch.cat(logits)).all(dim=-1)
        self.stats["nonfinite_logit_rows"] += int(bad.sum())

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
                 device=None):
        super().__init__(params, cfg, serve, device)
        self.ecfg = ecfg if ecfg is not None else EngineConfig()
        self.serve = dataclasses.replace(self.serve,
                                         cache_capacity=self.ecfg.max_seq)
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
        t0 = time.perf_counter()
        e, b = self.ecfg, len(reqs)
        prompts = np.zeros((b, e.bucket), np.int32)
        lens = np.zeros((b,), np.int32)
        for i, r in enumerate(reqs):
            prompts[i, :r.prompt.size] = r.prompt          # right-pad
            lens[i] = r.prompt.size
        self.stats["steps"] += 1
        self.stats["prefill_chunks"] += b
        logits, cache = lm.prefill(
            self.params, torch.from_numpy(prompts).to(self.device), self.cfg,
            self.serve, last_pos=torch.from_numpy(lens - 1).to(self.device))
        self._count_nonfinite(logits)
        max_new = min(max(r.max_new_tokens for r in reqs),
                      e.max_seq - int(lens.max()))
        outs = np.zeros((b, max_new), np.int32)
        tok = logits.argmax(dim=-1).to(torch.int32)
        tok_host = tok.cpu().numpy()         # waits for the prefill
        t_first = time.perf_counter()
        for r in reqs:
            r.ttft_s = t_first - r.submit_t
        alive = np.ones(b, bool)
        pos = torch.from_numpy(lens).to(self.device)
        for step in range(max_new):
            outs[:, step] = np.where(alive, tok_host, 0)
            if e.eos_id >= 0:
                alive &= outs[:, step] != e.eos_id
                if not alive.any():
                    outs = outs[:, :step + 1]
                    break
            self.stats["steps"] += 1
            logits, cache = lm.decode_step(self.params, cache, tok,
                                           pos + step, self.cfg, self.serve)
            self._count_nonfinite(logits)
            tok = logits.argmax(dim=-1).to(torch.int32)
            tok_host = tok.cpu().numpy()
            self.stats["decode_tokens"] += int(alive.sum())
        dt = time.perf_counter() - t0
        for i, r in enumerate(reqs):
            r.out_tokens = outs[i][:r.max_new_tokens]
            r.latency_s = dt
            r.status = "finished"
            self.stats["finished"] += 1
        return reqs


class PagedServingEngine(_EngineBase):
    """Continuous batching with one forward per step (see the module
    docstring).  A request the pools could never hold comes back
    rejected."""

    def __init__(self, params: dict, cfg: ModelConfig,
                 serve: lm.ServeConfig,
                 ecfg: Optional[PagedEngineConfig] = None, device=None):
        super().__init__(params, cfg, serve, device)
        self.ecfg = e = ecfg if ecfg is not None else PagedEngineConfig()
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
        self.pools = lm.init_paged_cache(cfg, self.pcfg, device=self.device)
        self.sched = Scheduler(
            SchedulerConfig(
                max_slots=e.max_slots, prefill_chunk=e.prefill_chunk,
                max_prefills=max(e.max_prefills, 1),
                transform_window=_transform_window(self.serve.stamp,
                                                   e.prefill_chunk),
                prefix_caching=e.prefix_caching),
            self.pcfg, swap_out=self._swap_out, swap_in=self._swap_in,
            cow=self._cow_copy, on_prefix=self._on_prefix_lookup)
        self._requests: Dict[int, Request] = {}
        self._rejected: List[Request] = []
        mp = max(e.max_prefills, 1)
        buckets, b = {0, mp}, 1
        while b < mp:
            buckets.add(b)
            b *= 2
        self._npf_buckets = sorted(buckets)

    # -- requests ---------------------------------------------------------
    def _max_prompt_len(self) -> int:
        return self.ecfg.max_seq - 1

    def _enqueue(self, req: Request) -> None:
        self._requests[req.uid] = req
        gen = min(req.max_new_tokens, self.ecfg.max_seq - req.prompt.size)
        nh, nl = PKV.pages_needed(req.prompt.size + gen - 1, self.pcfg)
        cap_hi, cap_lo = self.sched.alloc.capacity()
        if nh > cap_hi or nl > cap_lo:
            req.status, req.error = "rejected", (
                f"capacity-infeasible: needs {nh} hi + {nl} lo pages, the "
                f"pools hold {cap_hi} + {cap_lo}")
            req.out_tokens = np.zeros((0,), np.int32)
            self.stats["rejected"] += 1
            self._rejected.append(req)
        else:
            self.sched.submit(SchedRequest(uid=req.uid, prompt=req.prompt,
                                           max_new_tokens=req.max_new_tokens,
                                           arrival=req.uid))

    @torch.inference_mode()
    def run(self) -> List[Request]:
        """Drain the engine; every request comes back finished or
        rejected."""
        done, self._rejected = list(self._rejected), []
        while self.sched.has_work():
            self.stats["steps"] += 1
            plan = self.sched.plan_step()
            if plan.prefills or plan.decode:
                self._run_unified(plan, done)
        return done

    # -- scheduler callbacks ----------------------------------------------
    def _on_prefix_lookup(self, sreq: SchedRequest, match) -> None:
        self.stats["prefix_cache_queries"] += 1
        if match is not None:
            self.stats["prefix_cache_hits"] += 1
            self.stats["prefix_tokens_reused"] += match.matched

    def _cow_copy(self, sreq: SchedRequest, pool: str, src: int,
                  dst: int) -> None:
        PKV.copy_page(self.pools, pool, src, dst)
        self.stats["cow_copies"] += 1

    def _swap_out(self, sreq: SchedRequest) -> None:
        sreq.swapped = PKV.extract_pages(self.pools, sreq.hi_pages,
                                         sreq.lo_pages)
        self.stats["preemptions"] += 1
        self.stats["swap_bytes"] += PKV.swapped_bytes(sreq.swapped)

    def _swap_in(self, sreq: SchedRequest) -> None:
        PKV.insert_pages(self.pools, sreq.swapped, sreq.hi_pages,
                         sreq.lo_pages)
        self.stats["resumes"] += 1

    # -- one step ---------------------------------------------------------
    def _tables_np(self, sreqs: List[SchedRequest]) -> tuple:
        e, pc = self.ecfg, self.pcfg
        ht = np.zeros((e.max_slots, max(pc.hi_blocks_per_seq, 1)), np.int32)
        lt = np.zeros((e.max_slots, pc.max_blocks_per_seq), np.int32)
        for sreq in sreqs:
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

    def _run_unified(self, plan, done: List[Request]) -> None:
        """Build the step's ragged batch on the host and run it as one
        forward: ``n_pf`` chunk rows (bucketed; unused rows are null-page
        dummies) + the decode slot array."""
        e = self.ecfg
        c_len, s = e.prefill_chunk, e.max_slots
        works = plan.prefills
        n_pf = self._bucket_npf(len(works))
        pf_tokens = np.zeros((n_pf, c_len), np.int32)
        pf_start = np.zeros((n_pf,), np.int32)
        pf_length = np.zeros((n_pf,), np.int32)
        pf_last = np.zeros((n_pf,), np.int32)
        pages = np.zeros((n_pf * c_len + s,), np.int32)
        offs = np.zeros((n_pf * c_len + s,), np.int32)
        ishi = np.zeros((n_pf * c_len + s,), bool)
        for i, w in enumerate(works):
            valid = w.end - w.start
            pf_tokens[i, :valid] = w.sreq.prompt[w.start:w.end]
            pf_start[i], pf_length[i], pf_last[i] = w.start, w.end, valid - 1
            for t in range(valid):
                pages[i * c_len + t], offs[i * c_len + t], \
                    ishi[i * c_len + t] = self._write_target(w.sreq,
                                                             w.start + t)
        dec_tokens = np.zeros((s,), np.int32)
        dec_pos = np.zeros((s,), np.int32)
        base = n_pf * c_len
        for sreq in plan.decode:
            dec_tokens[sreq.slot] = sreq.generated[-1]
            dec_pos[sreq.slot] = sreq.pos
            pages[base + sreq.slot], offs[base + sreq.slot], \
                ishi[base + sreq.slot] = self._write_target(sreq, sreq.pos)
        ht_np, lt_np = self._tables_np([w.sreq for w in works] + plan.decode)
        pf_ht = np.zeros((n_pf, ht_np.shape[1]), np.int32)
        pf_lt = np.zeros((n_pf, lt_np.shape[1]), np.int32)
        for i, w in enumerate(works):
            pf_ht[i], pf_lt[i] = ht_np[w.sreq.slot], lt_np[w.sreq.slot]

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        pf_logits, dec_logits, self.pools = lm.paged_unified_step(
            self.params, self.pools, dev(pf_tokens), dev(pf_start),
            dev(pf_length), dev(pf_last), dev(dec_tokens), dev(dec_pos),
            dev(np.concatenate([pf_ht, ht_np])),
            dev(np.concatenate([pf_lt, lt_np])), dev(pages), dev(offs),
            dev(ishi), self.cfg, self.serve)
        pf_next = pf_logits.argmax(dim=-1).cpu().numpy()
        dec_next = dec_logits.argmax(dim=-1).cpu().numpy()
        self._count_nonfinite(pf_logits, dec_logits)

        for i, w in enumerate(works):
            sreq = w.sreq
            sreq.pos = w.end
            self.sched.register_prefix(sreq)
            self.stats["prefill_chunks"] += 1
            if w.end == sreq.prompt_len:
                sreq.generated.append(int(pf_next[i]))
                sreq.state = RUNNING
                req = self._requests[sreq.uid]
                req.ttft_s = time.perf_counter() - req.submit_t
                self._maybe_finish(sreq, done)
        for sreq in plan.decode:
            sreq.pos += 1
            sreq.generated.append(int(dec_next[sreq.slot]))
            self.stats["decode_tokens"] += 1
            self._maybe_finish(sreq, done)

    def _maybe_finish(self, sreq: SchedRequest, done: List[Request]) -> None:
        eos = self.ecfg.eos_id
        hit_eos = eos >= 0 and sreq.generated[-1] == eos
        cap = min(sreq.max_new_tokens, self.ecfg.max_seq - sreq.prompt_len)
        if hit_eos or len(sreq.generated) >= cap:
            req = self._requests[sreq.uid]
            req.out_tokens = np.asarray(sreq.generated[:sreq.max_new_tokens],
                                        np.int32)
            req.latency_s = time.perf_counter() - req.submit_t
            req.preemptions = sreq.preemptions
            req.status = "finished"
            self.sched.finish(sreq)
            self.stats["finished"] += 1
            done.append(req)

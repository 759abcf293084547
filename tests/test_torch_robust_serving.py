"""The port's request lifecycle and fault handling against the reference's
(``test_robust_serving.py`` and ``test_chaos.py``).

Each fault scenario runs the reference's paged engine and the port's on
the same weights (``from_jax_params``), prompts and seeded
:class:`FaultPlan`: every request must reach the reference's terminal
status, the plans must inject the same faults, and every lifecycle counter
must agree; the port's survivors must be token-identical to its own
fault-free run, and its scheduler quiescent (no slot or page leaked).  A
tick clock, read at the reference's points, must give the same deadline
misses, with the same messages, TTFTs and latencies.  Then the lifecycle
pieces on the port alone: submit validation, cancellation at every step,
shedding, the watermark, the watchdog, swap checksums and the prefix-cache
flush."""

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_platform_name", "cpu")

# One PyTorch thread a process: the tier-1 run puts six pytest workers on
# the machine's cores, where PyTorch's default of an OpenMP thread per core
# makes each worker's ops wait on the others' (tens of times slower).
torch.set_num_threads(1)

from repro.core.stamp import StampConfig as JStampConfig
from repro.models import lm as JLM
from repro.models.config import ModelConfig as JModelConfig
from repro.serving import kvcache as JKV
from repro.serving.engine import PagedEngineConfig as JPagedConfig
from repro.serving.engine import PagedServingEngine as JPaged
from repro.serving.faults import FaultPlan as JFaultPlan

from repro_torch.core.stamp import StampConfig as TStampConfig
from repro_torch.models import lm as TLM
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.serving import kvcache as TKV
from repro_torch.serving import paged_kvcache as TPKV
from repro_torch.serving.engine import BucketedEngine as TBucketed
from repro_torch.serving.engine import EngineConfig as TEngineConfig
from repro_torch.serving.engine import PagedEngineConfig as TPagedConfig
from repro_torch.serving.engine import PagedServingEngine as TPaged
from repro_torch.serving.faults import FaultPlan as TFaultPlan
from repro_torch.serving.faults import _draw, corrupt_swapped
from repro_torch.serving.scheduler import (CANCELLED, SchedRequest, Scheduler,
                                           SchedulerConfig)

DIMS = dict(name="robust-test", family="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128)
JCFG, TCFG = JModelConfig(**DIMS), TModelConfig(**DIMS)
PROMPT_LENS = (20, 45, 12, 30, 26)
MAX_NEW = (6, 4, 8, 5, 7)
TERMINAL = ("finished", "failed", "cancelled", "rejected")
FUSED = dict(num_hi_tokens=8, execution="fused")


@pytest.fixture(scope="module")
def jparams():
    return JLM.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def tparams(jparams):
    return TLM.from_jax_params(jax.tree.map(np.asarray, jparams), TCFG)


@pytest.fixture(autouse=True)
def _reset_reference_switches():
    yield
    JLM.set_fused_cache_attention(False)
    JLM.set_fused_decode_matmul(False)


def _prompts(seed=2, lens=PROMPT_LENS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, n) for n in lens]


def _shared(seed):
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, 128, 32)
    return [np.concatenate([pre, rng.integers(0, 128, w)])
            for w in (10, 14, 8, 12, 9)]


def _ecfg(**kw):
    return dict(dict(max_slots=5, prefill_chunk=16, max_seq=96,
                     block_size=16), **kw)


def _tserve(stamp=None, **kw):
    return TLM.ServeConfig(stamp=stamp and TStampConfig(**stamp),
                           kv=TKV.KVCacheConfig(quantized=True, num_hi=16),
                           **kw)


def _jserve(stamp=None, **kw):
    return JLM.ServeConfig(stamp=stamp and JStampConfig(**stamp),
                           kv=JKV.KVCacheConfig(quantized=True, num_hi=16),
                           **kw)


def _tpaged(tparams, ecfg=None, stamp=None, serve=None, **kw):
    return TPaged(tparams, TCFG, _tserve(stamp, **(serve or {})),
                  TPagedConfig(**(ecfg or _ecfg())), device="cpu", **kw)


def _drain(engine, prompts, max_new):
    uids = [engine.submit(p, m) for p, m in zip(prompts, max_new)]
    done = engine.run()
    assert sorted(r.uid for r in done) == sorted(uids)
    assert all(r.status in TERMINAL for r in done)
    return {r.uid: r for r in done}


# ---------------------------------------------------------------------------
# fault scenarios against the reference
# ---------------------------------------------------------------------------

# name -> (FaultPlan kwargs, engine config, prompts, max_new, stamp, guard)
SCENARIOS = {
    "exhaustion_storm": (
        dict(seed=5, exhaust_steps=frozenset(range(2, 40, 3))), _ecfg(),
        _prompts(), MAX_NEW, None, False),
    "swap_corruption": (
        dict(seed=1, corrupt_swap_ins=frozenset({0})),
        _ecfg(max_slots=2, num_lo_blocks=3, max_prefills=1),
        _prompts(11, (14, 40)), (6, 4), None, False),
    "watchdog": (
        dict(seed=0, exhaust_steps=frozenset(range(1, 10_000))),
        _ecfg(watchdog_steps=4), _prompts()[:1], MAX_NEW[:1], None, False),
    "seeded_soak": (
        dict(seed=3, exhaust_rate=0.35, corrupt_rate=0.5, nan_rate=0.01,
             window=(1, 60)),
        _ecfg(max_slots=3, num_lo_blocks=7, watchdog_steps=6), _prompts(),
        MAX_NEW, None, True),
    "serve_cli_chaos": (
        dict(seed=16, exhaust_rate=0.2, corrupt_rate=0.3, nan_rate=0.005),
        _ecfg(max_slots=3, num_lo_blocks=7), _prompts(4, (20, 33, 12, 26,
                                                          40, 17, 9, 30)),
        (6,) * 8, None, True),
    "prefix_exhaustion": (
        dict(seed=5, exhaust_steps=frozenset(range(2, 40, 3))),
        _ecfg(max_slots=2), _shared(21), (6,) * 5, None, False),
    "prefix_flush": (
        dict(seed=7, flush_prefix_steps=frozenset(range(1, 30, 4))),
        _ecfg(max_slots=2), _shared(23), (6,) * 5, None, False),
    "nan_guard_off": (
        dict(seed=0, nan_faults=frozenset({(1, 1)})), _ecfg(),
        _prompts()[:2], MAX_NEW[:2], None, False),
    "nan_demotion": (
        dict(seed=0, nan_faults=frozenset({(2, 2)})), _ecfg(max_slots=3),
        _prompts()[:3], MAX_NEW[:3], FUSED, True),
}


@pytest.fixture(scope="module", params=sorted(SCENARIOS))
def scenario(request, jparams, tparams):
    """One scenario run on both sides, plus the port's fault-free run of
    the same engine configuration."""
    plan, ecfg, prompts, max_new, stamp, guard = SCENARIOS[request.param]
    jfault, tfault = JFaultPlan(**plan), TFaultPlan(**plan)
    jeng = JPaged(jparams, JCFG, _jserve(stamp, numerics_guard=guard),
                  JPagedConfig(**ecfg), fault=jfault)
    jgot = _drain(jeng, prompts, max_new)
    teng = _tpaged(tparams, ecfg, stamp, dict(numerics_guard=guard),
                   fault=tfault)
    tgot = _drain(teng, prompts, max_new)
    clean = _drain(_tpaged(tparams, ecfg, stamp), prompts, max_new)
    return dict(name=request.param, jeng=jeng, teng=teng, jgot=jgot,
                tgot=tgot, clean=clean, jfault=jfault, tfault=tfault)


def test_terminal_states_and_faults_equal_reference(scenario):
    s = scenario
    assert {u: r.status for u, r in s["tgot"].items()} == \
        {u: r.status for u, r in s["jgot"].items()}
    assert s["tfault"].injected == s["jfault"].injected
    assert {u: len(r.out_tokens) for u, r in s["tgot"].items()} == \
        {u: len(r.out_tokens) for u, r in s["jgot"].items()}
    assert s["teng"].sched.quiescent()


def test_lifecycle_counters_equal_reference(scenario):
    """Every counter the reference keeps (swap bytes included) and the
    prefix-cache gauges."""
    js, ts = scenario["jeng"].stats, scenario["teng"].stats
    assert {k: ts[k] for k in js} == js


def test_survivors_match_fault_free_run(scenario):
    """Survivors keep the tokens of the port's fault-free run; a demoted
    engine's survivors run reference execution after the demotion, so
    they are held only to their token counts, and a request that took an
    injected NaN row with the guard off (its greedy pick read 0) only to
    its count."""
    s = scenario
    demoted = s["teng"].stats["demotions"] > 0
    nan_hit = {uid for _, kind, uid in s["teng"].events
               if kind == "fault_nan"}
    for uid, req in s["tgot"].items():
        if req.status != "finished":
            continue
        if uid in nan_hit:
            assert len(req.out_tokens) == len(s["clean"][uid].out_tokens)
            continue
        want = s["clean"][uid].out_tokens
        if demoted:
            assert len(req.out_tokens) == len(want)
        else:
            np.testing.assert_array_equal(req.out_tokens, want)


def test_scenarios_exercise_their_faults(scenario):
    """The comparisons above are vacuous unless the faults fired."""
    s, st = scenario, scenario["teng"].stats
    injected = s["tfault"].injected
    expect = {
        "exhaustion_storm": st["preemptions"] > 0 and all(
            r.status == "finished" for r in s["tgot"].values()),
        "swap_corruption": st["swap_corruptions"] == 1,
        "watchdog": st["watchdog_trips"] == 1,
        "seeded_soak": sum(injected.values()) >= 3,
        "serve_cli_chaos": injected["exhaustion"] > 0 and
        injected["swap_corruption"] > 0 and st["nan_quarantines"] > 0,
        "prefix_exhaustion": st["prefix_cache_hits"] > 0 and
        st["preemptions"] > 0,
        "prefix_flush": injected["prefix_flush"] > 0 and
        s["teng"].sched.alloc.all_free(),
        "nan_guard_off": s["tgot"][1].status == "finished" and
        s["tgot"][1].out_tokens[1] == 0,
        "nan_demotion": st["demotions"] == 1 and
        s["teng"].serve.stamp.execution == "reference",
    }
    assert expect[s["name"]]


def test_demotion_runs_the_kept_weights(tparams):
    """A quarantine under fused STaMP switches the engine to reference
    execution on the packed weights kept for it (wq/wk/wv apart, no
    prepared int8 buffers); with ``demote_on_nan`` off nothing is kept and
    the engine stays fused."""
    prompts = _prompts()[:3]
    eng = _tpaged(tparams, _ecfg(max_slots=3), FUSED,
                  dict(numerics_guard=True),
                  fault=TFaultPlan(seed=0, nan_faults=frozenset({(2, 2)})))
    assert eng._raw_params is not None
    got = _drain(eng, prompts, MAX_NEW[:3])
    assert got[2].status == "failed" and "non-finite" in got[2].error
    assert len(got[2].out_tokens) == 2
    assert "wq" in eng.params["layers"][0] and \
        "wqkv" not in eng.params["layers"][0]
    assert not eng.serve.fused_decode_matmul
    assert eng.stats["reference_fallback_sites"] == len(eng.eligibility)
    kinds = [k for _, k, _ in eng.events]
    assert {"fault_nan", "nan_quarantine", "demote"} <= set(kinds)
    off = _tpaged(tparams, _ecfg(max_slots=3, demote_on_nan=False), FUSED,
                  dict(numerics_guard=True),
                  fault=TFaultPlan(seed=0, nan_faults=frozenset({(1, 1)})))
    assert off._raw_params is None
    got = _drain(off, prompts, MAX_NEW[:3])
    assert got[1].status == "failed" and off.stats["demotions"] == 0
    assert off.serve.stamp.execution == "fused"


def test_fault_plan_draws_equal_reference():
    """The same seed draws the same faults: ``_draw`` per kind and
    ordinal, and a plan's decisions over a run of steps."""
    from repro.serving import faults as JF
    for kind in (1, 2, 3, 4):
        for key in ((0,), (3,), (7, 2), (123, 5)):
            assert _draw(11, kind, *key) == JF._draw(11, kind, *key)
    plans = [m(seed=4, exhaust_rate=0.3, corrupt_rate=0.4, nan_rate=0.2,
               flush_rate=0.25, window=(2, 30))
             for m in (JFaultPlan, TFaultPlan)]
    seen = []
    for plan in plans:
        out = []
        for step in range(40):
            plan.begin_step(step)
            out.append((plan.exhausted(), plan.flush_prefix(),
                        plan.corrupt_swap(1), plan.nan_logits(step % 5, 3)))
        seen.append((out, plan.injected))
    assert seen[0] == seen[1]


# ---------------------------------------------------------------------------
# the tick clock: deadlines against the reference
# ---------------------------------------------------------------------------

class TickClock:
    def __init__(self):
        self.t, self.reads = 0.0, 0

    def __call__(self):
        self.reads += 1
        self.t += 1.0
        return self.t


DEADLINES = [(None, None), (25.0, None), (None, 5.0), (14.0, 6.0),
             (40.0, None)]


@pytest.mark.parametrize("step_mode", ["unified", "two_call"])
def test_tick_clock_deadlines_equal_reference(jparams, tparams, step_mode):
    """Deadlines under a clock that advances one second a read: the port
    reads it where the reference does, so the same requests miss, with the
    same messages, TTFTs and latencies, and the clocks end equal."""
    prompts = _prompts()
    ecfg = _ecfg(max_slots=3, step_mode=step_mode)
    out = []
    for mk in (lambda clk: JPaged(jparams, JCFG, _jserve(),
                                  JPagedConfig(**ecfg), clock=clk),
               lambda clk: _tpaged(tparams, ecfg, clock=clk)):
        clk = TickClock()
        eng = mk(clk)
        for p, m, (dl, ttft) in zip(prompts, MAX_NEW, DEADLINES):
            eng.submit(p, m, deadline_s=dl, ttft_deadline_s=ttft)
        done = eng.run()
        out.append(({r.uid: (r.status, r.error, r.ttft_s, r.latency_s)
                     for r in done}, eng.stats["deadline_misses"],
                    clk.reads))
        if len(out) == 2:
            assert eng.sched.quiescent()
    (jres, jmiss, jreads), (tres, tmiss, treads) = out
    assert tres == jres and tmiss == jmiss and treads == jreads
    assert jmiss >= 2


# ---------------------------------------------------------------------------
# the lifecycle on the port alone (test_robust_serving.py's cases)
# ---------------------------------------------------------------------------

@pytest.fixture(params=["paged", "bucketed"])
def any_engine(request, tparams):
    if request.param == "paged":
        return _tpaged(tparams)
    return TBucketed(tparams, TCFG, _tserve(),
                     TEngineConfig(max_batch=4, bucket=64, max_seq=96),
                     device="cpu")


@pytest.mark.parametrize("prompt,max_new,match", [
    (np.zeros(0, np.int32), 4, "empty prompt"),
    (np.arange(5), 0, "max_new_tokens"),
    (np.arange(5), -3, "max_new_tokens"),
    (np.arange(500) % 128, 4, "prompt length"),
])
def test_submit_validation(any_engine, prompt, max_new, match):
    with pytest.raises(ValueError, match=match):
        any_engine.submit(prompt, max_new)
    if isinstance(any_engine, TPaged):
        assert any_engine.sched.quiescent()
    else:
        assert any_engine.queue == []


def test_every_terminal_state_reaches_done(tparams):
    pe = _tpaged(tparams, _ecfg(num_lo_blocks=2))
    prompts = _prompts()
    ok = pe.submit(prompts[2], 2)
    bad = pe.submit(prompts[1], 40)              # capacity-infeasible
    gone = pe.submit(prompts[2], 2)
    assert pe.cancel(gone) and not pe.cancel(gone) and not pe.cancel(999)
    by_uid = {r.uid: r for r in pe.run()}
    assert (by_uid[ok].status, by_uid[bad].status, by_uid[gone].status) == \
        ("finished", "rejected", "cancelled")
    assert pe.stats["cancelled"] == 1 and pe.stats["rejected"] == 1
    assert pe.sched.quiescent()


def test_cancel_mid_decode_keeps_partial_tokens(tparams):
    pe = _tpaged(tparams)
    prompts = _prompts()
    uid = pe.submit(prompts[0], 8)               # 20 tokens → 2 chunks
    other = pe.submit(prompts[2], 8)
    done = []
    for _ in range(4):
        pe._step(done)
    assert pe.cancel(uid)
    assert pe.request(uid).status == "cancelled"
    assert 0 < len(pe.request(uid).out_tokens) < 8
    done += pe.run()
    assert pe.request(other).status == "finished"
    assert pe.sched.quiescent()


@pytest.mark.parametrize("step_mode", ["unified", "two_call"])
def test_cancel_at_every_step_leaks_nothing(tparams, step_mode):
    """Cancelling a three-chunk prefill at every engine step index returns
    every slot and page."""
    k = 0
    while True:
        pe = _tpaged(tparams, _ecfg(step_mode=step_mode))
        uid = pe.submit(_prompts()[1], 4)        # 45 tokens → 3 chunks
        done = []
        for _ in range(k):
            if not pe.sched.has_work():
                break
            pe._step(done)
        if not pe.sched.has_work():
            break
        assert pe.cancel(uid) and pe.sched.quiescent(), k
        k += 1
    assert k >= 6


def test_cancel_preempted_request_releases_host_copy():
    scfg = SchedulerConfig(max_slots=2, prefill_chunk=16)
    pcfg = TPKV.PagedCacheConfig(block_size=8, num_lo_blocks=5,
                                 num_hi_blocks=3, max_blocks_per_seq=6,
                                 quant=TKV.KVCacheConfig(quantized=True,
                                                         num_hi=16))
    swaps = {}
    sched = Scheduler(scfg, pcfg,
                      swap_out=lambda r: swaps.setdefault(r.uid, {}),
                      swap_in=lambda r: None)
    a = SchedRequest(uid=1, prompt=np.zeros(16, np.int32), max_new_tokens=4,
                     arrival=1)
    sched.submit(a)
    sched.plan_step()
    a.pos = 16
    sched._preempt(a)
    a.swapped = {0: {}}
    assert sched.cancel(a.uid) is a and a.state == CANCELLED
    assert a.swapped is None and sched.quiescent()


def test_ttft_deadline_applies_only_before_the_first_token(tparams):
    clk = [0.0]
    pe = _tpaged(tparams, clock=lambda: clk[0])
    uid = pe.submit(_prompts()[2], 6, ttft_deadline_s=5.0)
    done = []
    clk[0] = 1.0
    pe._step(done)                               # one chunk → first token
    assert pe.request(uid).ttft_s == 1.0
    clk[0] = 100.0
    pe.run()
    assert pe.request(uid).status == "finished"
    assert pe.stats["deadline_misses"] == 0


@pytest.mark.parametrize("policy,victim", [("reject_newest", 3),
                                           ("shed_oldest", 1)])
def test_shedding(tparams, policy, victim):
    pe = _tpaged(tparams, _ecfg(max_waiting=2, shed_policy=policy))
    uids = [pe.submit(_prompts()[2], 2) for _ in range(3)]
    assert pe.request(victim).status == "rejected"
    assert pe.stats["shed"] == 1
    done = pe.run()
    assert {r.uid for r in done} == set(uids)
    assert all(pe.request(u).status == "finished" for u in uids
               if u != victim)
    assert pe.sched.quiescent()


@pytest.mark.parametrize("field,value", [("shed_policy", "drop_all"),
                                         ("step_mode", "three_call")])
def test_unknown_policies_refused(tparams, field, value):
    with pytest.raises(ValueError, match=field):
        _tpaged(tparams, _ecfg(**{field: value}))


def test_watermark_preempts_early_and_stays_bit_identical(tparams):
    prompts = _prompts()[:3]
    want = _drain(_tpaged(tparams, _ecfg(max_slots=3)), prompts, (5,) * 3)
    pe = _tpaged(tparams, _ecfg(max_slots=3, num_lo_blocks=9,
                                preempt_watermark=0.5))
    got = _drain(pe, prompts, (5,) * 3)
    assert pe.stats["preemptions"] > 0
    for uid in want:
        np.testing.assert_array_equal(got[uid].out_tokens,
                                      want[uid].out_tokens)
    assert pe.sched.quiescent()


# ---------------------------------------------------------------------------
# swap checksums, corruption and the prefix-cache flush
# ---------------------------------------------------------------------------

def _pools():
    pcfg = TPKV.PagedCacheConfig(block_size=16, num_lo_blocks=6,
                                 num_hi_blocks=2, max_blocks_per_seq=6,
                                 quant=TKV.KVCacheConfig(quantized=True,
                                                         num_hi=16))
    pools = TLM.init_paged_cache(TCFG, pcfg, device="cpu")
    gen = np.random.default_rng(0)
    for entry in pools:
        for t in entry.values():
            t.copy_(torch.from_numpy(gen.integers(0, 100, t.shape)))
    return pools


def test_swap_round_trip_and_corruption_refused():
    pools = _pools()
    swapped = TPKV.extract_pages(pools, [1], [2, 3])
    assert TPKV.CRC_KEY in swapped and TPKV.swapped_bytes(swapped) > 0
    TPKV.verify_swapped(swapped)
    before = [{k: v.clone() for k, v in e.items()} for e in pools]
    bad = corrupt_swapped(swapped, seed=11)
    with pytest.raises(TPKV.SwapCorruption):
        TPKV.insert_pages(pools, bad, [1], [4, 5])
    for e, b in zip(pools, before):                # nothing was written
        assert all((e[k] == b[k]).all() for k in e)
    TPKV.insert_pages(pools, swapped, [1], [4, 5])
    assert all((pools[i]["k_lo"][[4, 5]] == before[i]["k_lo"][[2, 3]]).all()
               for i in range(len(pools)))
    TPKV.verify_swapped({0: {"k": np.zeros(3)}})   # no checksums: passes


def test_corrupt_swapped_flips_one_byte_of_one_array():
    swapped = TPKV.extract_pages(_pools(), [1], [2, 3])
    bad = corrupt_swapped(swapped, seed=3)
    diffs = [(i, n) for i in swapped if i != TPKV.CRC_KEY
             for n in swapped[i]
             if not np.array_equal(swapped[i][n], bad[i][n])]
    assert diffs == [(0, "k_hi")]
    assert bad[TPKV.CRC_KEY] == swapped[TPKV.CRC_KEY]


def test_flush_cache_and_fault_hook():
    cfg = TPKV.PagedCacheConfig(block_size=4, num_lo_blocks=6,
                                num_hi_blocks=3, max_blocks_per_seq=4,
                                quant=TKV.KVCacheConfig(quantized=True,
                                                        num_hi=4))
    alloc = TPKV.BlockAllocator(cfg)
    prompt = np.arange(12, dtype=np.int32)
    hi, lo = [alloc.alloc_hi()], [alloc.alloc_lo(), alloc.alloc_lo()]
    assert alloc.register_prefix(prompt, 12, hi, lo) == 3
    alloc.release(hi[:1], lo[:1])                 # two pages park, one held
    assert alloc.cache_stats()["evictable_pages"] == 2
    assert alloc.flush_cache() == 3
    assert alloc.cache_stats()["cached_pages"] == 0
    assert alloc.free_counts() == (2, 4)
    alloc.release([], lo[1:])
    assert alloc.free_counts() == (2, 5) and alloc.all_free()
    alloc.fault = lambda: True
    assert not alloc.can_allocate(0, 1) and alloc.can_allocate(0, 0)
    with pytest.raises(TPKV.OutOfBlocks):
        alloc.alloc_lo()

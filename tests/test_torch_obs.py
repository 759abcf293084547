"""The port's observability layer against the reference's (``test_obs.py``'s
cases, on both sides where both exist): the metrics registry (bucket
semantics, percentiles against a numpy oracle, JSON and Prometheus text
byte-identical to the reference's for the same calls), structured events
and their Chrome-trace export, the step timer on a tick clock, the
quant-health site stats against a numpy oracle and the reference's, and the
engines: the same metric names and counter values as the reference engine
after the same run, per-site ``quant_*_total`` counters and ``moe_router``
gauges equal on reduced llama3-8b and Arctic (the reference run in a
process of its own without XLA's excess precision, where fused execution
is bit-equal to the port's; ROADMAP §3, open item 2), and telemetry off
adding nothing to a step: the same kernel-wrapper calls and one host
transfer a step function call."""

import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_platform_name", "cpu")

# One PyTorch thread a process: the tier-1 run puts six pytest workers on
# the machine's cores, where PyTorch's default of an OpenMP thread per core
# makes each worker's ops wait on the others' (tens of times slower).
torch.set_num_threads(1)

from repro.models import lm as JLM
from repro.models.config import ModelConfig as JModelConfig
from repro.obs import metrics as JMET
from repro.obs import quantstats as JQS
from repro.obs import trace as JTR
from repro.serving import kvcache as JKV
from repro.serving.engine import BucketedEngine as JBucketed
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import PagedEngineConfig as JPagedConfig
from repro.serving.engine import PagedServingEngine as JPaged

from repro_torch import configs as TCONFIGS
from repro_torch.core import quant as TQ
from repro_torch.core.stamp import StampConfig as TStampConfig
from repro_torch.kernels import decode_matmul as TDM
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import paged_attention as TPA
from repro_torch.models import lm as TLM
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.obs import metrics as TMET
from repro_torch.obs import quantstats as TQS
from repro_torch.obs import trace as TTR
from repro_torch.serving import kvcache as TKV
from repro_torch.serving.engine import BucketedEngine as TBucketed
from repro_torch.serving.engine import EngineConfig as TEngineConfig
from repro_torch.serving.engine import PagedEngineConfig as TPagedConfig
from repro_torch.serving.engine import PagedServingEngine as TPaged

DIMS = dict(name="obs-test", family="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128)
JCFG, TCFG = JModelConfig(**DIMS), TModelConfig(**DIMS)
PAGED = dict(max_slots=3, prefill_chunk=16, max_seq=96, block_size=16)
BUCKETED = dict(max_batch=4, bucket=64, max_seq=96)
# the port's own counters beside the reference's STAT_KEYS
EXTRA = set(TPaged.EXTRA_KEYS)
TELEMETRY_ARCHS = ("llama3-8b", "arctic-480b")
REFERENCE_TIMEOUT_S = 300


def _jserve(**kw):
    return JLM.ServeConfig(kv=JKV.KVCacheConfig(quantized=True, num_hi=16),
                           **kw)


def _tserve(**kw):
    return TLM.ServeConfig(kv=TKV.KVCacheConfig(quantized=True, num_hi=16),
                           **kw)


@pytest.fixture(scope="module")
def jparams():
    return JLM.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def tparams(jparams):
    return TLM.from_jax_params(jax.tree.map(np.asarray, jparams), TCFG)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 128, n) for n in (20, 33, 12)]


@pytest.fixture(autouse=True)
def _reset_reference_switches():
    yield
    JLM.set_fused_cache_attention(False)
    JLM.set_fused_decode_matmul(False)


def _run(engine, prompts, max_new=6):
    for p in prompts:
        engine.submit(p, max_new_tokens=max_new)
    return engine.run()


class TickClock:
    """Each read advances by ``tick`` and is counted."""

    def __init__(self, tick=1.0):
        self.t, self.tick, self.reads = 0.0, tick, 0

    def __call__(self):
        self.reads += 1
        self.t += self.tick
        return self.t


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


def test_histogram_le_semantics():
    h = TMET.Histogram((1.0, 2.0, 4.0))
    for v in (0.5, 1.0, 1.5, 4.0, 9.0):
        h.observe(v)
    assert h.counts == [2, 1, 1, 1] and h.count == 5
    assert h.sum == pytest.approx(16.0)


def test_histogram_percentile_vs_numpy_oracle():
    """Dense geometric buckets: the interpolated estimate lands inside the
    bucket that covers numpy's exact quantile."""
    rng = np.random.default_rng(7)
    xs = rng.lognormal(mean=-3.0, sigma=1.0, size=4000)
    edges = TMET.exponential_buckets(1e-4, 1.15, 80)
    h = TMET.Histogram(edges)
    for v in xs:
        h.observe(v)
    for q in (0.5, 0.9, 0.99):
        exact = float(np.quantile(xs, q))
        i = int(np.searchsorted(edges, exact))
        lo = edges[i - 1] if i > 0 else 0.0
        hi = edges[min(i, len(edges) - 1)]
        assert lo * 0.999 <= h.percentile(q) <= hi * 1.001


def test_histogram_edge_cases_and_buckets():
    h = TMET.Histogram((1.0, 2.0))
    assert h.percentile(0.5) == 0.0
    h.observe(100.0)
    assert h.percentile(0.5) == 2.0
    with pytest.raises(ValueError):
        h.percentile(1.5)
    with pytest.raises(ValueError):
        TMET.Histogram((2.0, 1.0))
    assert TMET.exponential_buckets(0.5, 2.0, 4) == (0.5, 1.0, 2.0, 4.0)
    for bad in ((0.0, 2.0, 4), (0.5, 1.0, 4), (0.5, 2.0, 0)):
        with pytest.raises(ValueError):
            TMET.exponential_buckets(*bad)
    assert TMET.LATENCY_BUCKETS == JMET.LATENCY_BUCKETS


def test_registry_rules():
    reg = TMET.MetricsRegistry()
    c = reg.counter("ops")
    c.inc()
    c.inc(3)
    assert c.value == 4
    with pytest.raises(ValueError):
        c.inc(-1)
    assert reg.counter("x", labels={"site": "qkv"}) is \
        reg.counter("x", labels={"site": "qkv"})
    assert reg.counter("x", labels={"site": "wo"}) is not \
        reg.counter("x", labels={"site": "qkv"})
    with pytest.raises(ValueError):
        reg.gauge("ops")
    with pytest.raises(ValueError):
        reg.counter("bad name!")
    reg.counter("recompiles").inc(5)
    reg.histogram("ttft_s").observe(0.1)
    reg.reset(exclude=("recompiles",))
    assert reg.counter("recompiles").value == 5 and c.value == 0
    assert reg.histogram("ttft_s").count == 0


def _calls_scalars(reg):
    reg.counter("steps", help="engine steps").inc(2)
    reg.counter("steps").inc(0.5)
    reg.gauge("load", labels={"k": "waiting"}).set(3)
    reg.gauge("load", labels={"k": "active"}).set(-1.25)
    reg.gauge("big").set(1e16)


def _calls_histograms(reg):
    h = reg.histogram("lat", buckets=(1.0, 2.0))
    for v in (0.5, 1.5, 9.0):
        h.observe(v)
    reg.histogram("ttft_s", help="request ttft_s").observe(0.013)
    reg.histogram("step_phase_s", labels={"phase": "plan"}).observe(2e-4)
    reg.histogram("step_phase_s", labels={"phase": "dispatch"}).observe(3)


def _calls_labeled(reg):
    for site in ("wo", "qkv", "gate_up"):
        lbl = {"site": site}
        reg.counter("quant_clipped_total", labels=lbl,
                    help="quant telemetry: cumulative clipped").inc(3)
        reg.gauge("quant_clip_rate", labels=lbl,
                  help="quant telemetry: last-step clip_rate").set(1 / 3)
    reg.counter("moe_dropped_tokens").inc(7.0)
    reg.reset(exclude=("moe_dropped_tokens",))
    reg.gauge("quant_clip_rate", labels={"site": "wo"}).set(0.1)


@pytest.mark.parametrize("calls", [_calls_scalars, _calls_histograms,
                                   _calls_labeled],
                         ids=["scalars", "histograms", "labeled_reset"])
def test_exposition_byte_identical_to_reference(calls):
    """The same sequence of calls renders the same bytes: ``to_json``
    (snapshot at an injected clock), ``to_prometheus`` and the snapshot."""
    regs = [m.MetricsRegistry(clock=lambda: 123.0) for m in (JMET, TMET)]
    for reg in regs:
        calls(reg)
    ref, port = regs
    assert port.to_json() == ref.to_json()
    assert port.to_json(indent=None) == ref.to_json(indent=None)
    assert port.to_prometheus() == ref.to_prometheus()
    assert port.snapshot() == ref.snapshot()


# ---------------------------------------------------------------------------
# events, step timer and the Chrome trace
# ---------------------------------------------------------------------------

def _lifecycle(tr):
    """One request through submit → admit → chunk → first token →
    preempt → admit → finish, with a phase slice, in ``tr``'s Event."""
    E = tr.Event
    return [
        E(0, "submit", uid=1, t=0.0, fields={"prompt_len": 20}),
        E(1, "phase", t=0.5, dur=0.2, phase="plan"),
        E(1, "admit", uid=1, t=1.0),
        E(1, "prefill_chunk", uid=1, t=1.0, dur=0.5,
          fields={"start": 0, "end": 16}),
        E(2, "first_token", uid=1, t=2.0),
        E(3, "preempt", uid=1, t=3.0),
        E(4, "admit", uid=1, t=4.0),
        E(4, "resume", uid=1, t=4.0),
        E(4, "fail", uid=2, t=4.5, fields={"error": "deadline"}),
        E(5, "quant_clip_alert", t=4.6, fields={"site": "wo"}),
        E(5, "finish", uid=1, t=5.0),
        E(6, "submit", uid=3, t=5.5),
    ]


@pytest.mark.parametrize("kind,fields,uid,payload", [
    ("prefill_chunk", {"start": 0, "end": 16}, 1, (1, 0, 16)),
    ("decode", {"uids": (1, 2, 5)}, None, (1, 2, 5)),
    ("demote", {"to": "reference"}, None, "reference"),
    ("fault_exhaust", {}, None, 6),
    ("fail", {"error": "deadline"}, 2, (2, "deadline")),
    ("finish", {}, 3, 3),
])
def test_event_legacy_payloads(kind, fields, uid, payload):
    ev = TTR.Event(6, kind, uid=uid, fields=fields)
    assert tuple(ev) == (6, kind, payload)
    assert tuple(ev) == tuple(JTR.Event(6, kind, uid=uid, fields=fields))


def test_step_timer_reads_the_clock_twice_a_phase():
    clk = TickClock()
    reg = TMET.MetricsRegistry()
    slices = []
    timer = TTR.StepTimer(reg, clk, on_phase=lambda n, t0, d:
                          slices.append((n, t0, d)))
    with timer.phase("plan"):
        pass
    with pytest.raises(RuntimeError):
        with timer.phase("dispatch"):
            raise RuntimeError("boom")
    assert clk.reads == 4
    assert slices == [("plan", 1.0, 1.0), ("dispatch", 3.0, 1.0)]
    assert reg.histogram("step_phase_s",
                         labels={"phase": "dispatch"}).count == 1


def test_chrome_trace_equals_reference():
    """The same event ring exports to the same trace document; its spans
    follow the request through WAITING / PREFILLING / DECODING."""
    doc = TTR.export_chrome_trace(_lifecycle(TTR), engine="paged")
    assert doc == JTR.export_chrome_trace(_lifecycle(JTR), engine="paged")
    names = [e["name"] for e in doc["traceEvents"]
             if e["ph"] == "X" and e["tid"] == 2]
    assert names.count("WAITING") == 2 and "PREFILLING" in names
    assert json.loads(json.dumps(doc)) == doc
    assert TTR.export_chrome_trace([])["traceEvents"] == []


# ---------------------------------------------------------------------------
# quant-health site stats
# ---------------------------------------------------------------------------

def test_site_stats_tight_scales_vs_numpy_oracle():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 8, 64)).astype(np.float32)
    scale = np.full((1, 8, 1), 0.08, np.float32)
    zp = np.full((1, 8, 1), 7.0, np.float32)
    q = np.round(x / scale) + zp
    clipped = int(np.sum((q < -0.5) | (q > 15.5)))
    qc = np.clip(q, 0.0, 15.0)
    saturated = int(np.sum((qc <= 0.5) | (qc >= 14.5)))
    assert clipped > 0
    out = TQS.site_stats(torch.from_numpy(x), 4.0, 8,
                         scale=torch.from_numpy(scale),
                         zp=torch.from_numpy(zp))
    assert int(out["clipped"]) == clipped
    assert int(out["saturated"]) == saturated


@pytest.mark.parametrize("shape,num_hi", [((2, 16, 32), 4), ((1, 8, 64), 0),
                                         ((3, 16, 48), 16)])
def test_site_stats_equal_reference(shape, num_hi):
    """Min-max scales on both sides: every count equal to ``jax.jit`` of the
    reference's ``site_stats`` at a per-token bits vector."""
    rng = np.random.default_rng(sum(shape) + num_hi)
    x = rng.normal(size=shape).astype(np.float32) * \
        rng.uniform(0.5, 4.0, size=shape[:-1] + (1,)).astype(np.float32)
    s = shape[-2]
    jbits = jnp.asarray(np.where(np.arange(s) < num_hi, 8.0, 4.0),
                        jnp.float32)
    ref = jax.jit(lambda a, b: JQS.site_stats(a, b, 8))(jnp.asarray(x),
                                                        jbits)
    got = TQS.site_stats(torch.from_numpy(x),
                         TQ.mixed_precision_bits(s, num_hi), 8)
    assert set(got) == set(ref)
    for k in ("clipped", "saturated", "elems", "hi_tokens", "tokens"):
        assert float(got[k]) == float(ref[k]), k
    for k in ("scale_min", "scale_max"):
        assert float(got[k]) == pytest.approx(float(ref[k]), rel=1e-6)
    summ = TQS.summarize({"qkv": got})["qkv"]
    assert summ["hi_coverage"] == pytest.approx(num_hi / s)


def test_collector_scope_and_transfer_layout():
    assert not TQS.active()
    TQS.begin()
    TQS.record("qkv", torch.ones(1, 4, 8), 4.0, 8)
    TQS.record("qkv", torch.ones(1, 4, 8), 4.0, 8)
    TQS.record_extra("moe_router", {"expert_tokens": torch.tensor([1., 2.]),
                                    "dropped_tokens": torch.tensor(3.0)})
    out = TQS.end()
    assert not TQS.active() and float(out["qkv"]["tokens"]) == 8.0
    TQS.record("qkv", torch.ones(1, 4, 8), 4.0, 8)      # outside a scope
    assert TQS.end() == {}
    layout, parts = TQS.flatten(out)
    back = TQS.unflatten(layout, torch.cat(parts).numpy())
    assert back["moe_router"]["expert_tokens"].tolist() == [1.0, 2.0]
    assert float(back["qkv"]["tokens"]) == 8.0
    assert TQS.summarize(back) == TQS.summarize(
        {s: {k: v.numpy() for k, v in d.items()} for s, d in out.items()})


# ---------------------------------------------------------------------------
# engines: the reference's surface, names and values
# ---------------------------------------------------------------------------

def _engines(kind, jparams, tparams, **serve):
    if kind == "bucketed":
        return (JBucketed(jparams, JCFG, _jserve(**serve),
                          JEngineConfig(**BUCKETED)),
                TBucketed(tparams, TCFG, _tserve(**serve),
                          TEngineConfig(**BUCKETED), device="cpu"))
    ecfg = dict(PAGED, step_mode=kind)
    return (JPaged(jparams, JCFG, _jserve(**serve), JPagedConfig(**ecfg)),
            TPaged(tparams, TCFG, _tserve(**serve), TPagedConfig(**ecfg),
                   device="cpu"))


@pytest.fixture(scope="module")
def engine_runs(jparams, tparams, prompts):
    """Each engine kind run on both sides on the same prompts (stamp off,
    quantized cache)."""
    out = {}
    for kind in ("unified", "two_call", "bucketed"):
        jeng, teng = _engines(kind, jparams, tparams)
        jdone, tdone = _run(jeng, prompts), _run(teng, prompts)
        out[kind] = (jeng, teng, jdone, tdone)
    return out


def _names(engine) -> dict:
    snap = engine.metrics.snapshot()
    return {k: set(snap[k]) for k in ("counters", "gauges", "histograms")}


@pytest.mark.parametrize("kind", ["unified", "two_call", "bucketed"])
def test_metric_names_equal_reference(engine_runs, kind):
    """Every family and child the reference engine publishes, the port's
    publishes, and nothing else but the port's two extra counters."""
    jeng, teng = engine_runs[kind][:2]
    jn, tn = _names(jeng), _names(teng)
    assert tn["counters"] == jn["counters"] | EXTRA
    assert tn["gauges"] == jn["gauges"]
    assert tn["histograms"] == jn["histograms"]
    assert set(teng.stats) == set(jeng.stats) | EXTRA


@pytest.mark.parametrize("kind", ["unified", "two_call", "bucketed"])
def test_counter_values_and_tokens_equal_reference(engine_runs, kind):
    """Counters, gauges, histogram counts and the event kinds equal the
    reference's after the same run (the schedule does not depend on token
    values; the tokens themselves are held in ``test_torch_two_call.py``,
    here a near-tie of the transform-free step may fork one request's
    later tokens)."""
    jeng, teng, jdone, tdone = engine_runs[kind]
    js, ts = jeng.metrics.snapshot(), teng.metrics.snapshot()
    for k, v in js["counters"].items():
        assert ts["counters"][k] == v, k
    assert ts["gauges"] == js["gauges"]
    for k, h in js["histograms"].items():
        assert ts["histograms"][k]["count"] == h["count"], k
    assert [len(r.out_tokens) for r in tdone] == \
        [len(r.out_tokens) for r in jdone]
    assert [k for _, k, _ in teng.events] == [k for _, k, _ in jeng.events]


def test_bucketed_engine_registry_surface(engine_runs):
    teng, tdone = engine_runs["bucketed"][1], engine_runs["bucketed"][3]
    st = teng.stats
    assert set(st) == set(teng.STAT_KEYS) | EXTRA | \
        {"reference_fallback_sites"}
    assert st["steps"] > 0 and st["device_dispatches"] == st["steps"]
    assert st["finished"] == len(tdone)
    assert teng.metrics.histogram("ttft_s").count == len(tdone)
    teng.reset_stats(clear_events=True)
    assert teng.stats["finished"] == 0 and len(teng.events) == 0


def test_paged_trace_round_trip(engine_runs):
    teng, tdone = engine_runs["unified"][1], engine_runs["unified"][3]
    doc = TTR.export_chrome_trace(teng.events, engine="paged")
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    for r in tdone:
        names = {e["name"] for e in spans if e["tid"] == r.uid + 1}
        assert {"WAITING", "PREFILLING", "DECODING"} <= names
    terminals = [e for e in doc["traceEvents"]
                 if e["ph"] == "i" and e["name"].startswith("terminal")]
    assert len(terminals) == len(tdone)
    assert {e["name"] for e in spans if e["tid"] == 0} <= \
        {"plan", "dispatch", "post"}
    load = teng.metrics.snapshot()["gauges"]
    assert load["sched_waiting"] == 0 and load["sched_active"] == 0


def test_obs_clock_isolated_from_engine_clock(tparams, prompts):
    obs = TickClock(tick=0.25)
    eng = TPaged(tparams, TCFG, _tserve(), TPagedConfig(**PAGED),
                 device="cpu", obs_clock=obs)
    done = _run(eng, prompts)
    assert obs.reads > 0
    ts = [e.t for e in eng.events]
    assert ts == sorted(ts)
    assert all(0.0 <= r.latency_s < 60.0 for r in done)


def test_clip_alert_fires_below_threshold(tparams, prompts):
    serve = _tserve(stamp=TStampConfig(num_hi_tokens=8),
                    quant_telemetry=True)
    eng = TPaged(tparams, TCFG, serve,
                 TPagedConfig(**PAGED, clip_alert_threshold=-1.0),
                 device="cpu")
    _run(eng, prompts)
    alerts = {k: v for k, v in eng.metrics.snapshot()["counters"].items()
              if k.startswith("quant_clip_alerts")}
    assert alerts and all(v > 0 for v in alerts.values())
    assert "quant_clip_alert" in [k for _, k, _ in eng.events]


# ---------------------------------------------------------------------------
# telemetry off adds nothing; telemetry on adds no wrapper call
# ---------------------------------------------------------------------------

_WRAPPED = [(TOPS, "stamp_transform_quantize"), (TOPS, "stamp_int_gemm"),
            (TLM, "stamp_decode_matmul"), (TDM, "stamp_decode_matmul"),
            (TPA, "paged_ragged_attention"), (TLM, "paged_ragged_attention")]


def _count_calls(monkeypatch):
    """Count the kernel wrappers' calls (on the CPU they run their plain
    versions, so ``ops.launch_counts`` stays 0), the host transfers and the
    telemetry scopes opened."""
    calls = {"cpu": 0, "item": 0, "scopes": 0}

    def wrap(key, fn):
        def counted(*a, **kw):
            calls[key] = calls.get(key, 0) + 1
            return fn(*a, **kw)
        return counted

    for mod, name in _WRAPPED:
        monkeypatch.setattr(mod, name, wrap(name, getattr(mod, name)))
    for name, key in (("cpu", "cpu"), ("item", "item")):
        monkeypatch.setattr(torch.Tensor, name,
                            wrap(key, getattr(torch.Tensor, name)))
    monkeypatch.setattr(TQS, "begin", wrap("scopes", TQS.begin))
    return calls


@pytest.mark.parametrize("kind", ["unified", "two_call", "bucketed"])
def test_telemetry_adds_no_wrapper_call_and_no_transfer(
        tparams, prompts, monkeypatch, kind):
    """Fused STaMP with the decode and attention kernels: with telemetry
    off no scope opens and each step function call makes exactly one host
    transfer; with telemetry on the kernel wrappers are called exactly as
    often, still one transfer a call, and the tokens are the same."""
    fused = TStampConfig(num_hi_tokens=8, execution="fused")
    runs = {}
    for on in (False, True):
        serve = _tserve(stamp=fused, fused_cache_attention=True,
                        quant_telemetry=on)
        if kind == "bucketed":
            eng = TBucketed(tparams, TCFG, serve, TEngineConfig(**BUCKETED),
                            device="cpu")
        else:
            eng = TPaged(tparams, TCFG, serve,
                         TPagedConfig(**PAGED, step_mode=kind), device="cpu")
        with monkeypatch.context() as m:
            calls = _count_calls(m)
            done = _run(eng, prompts)
        runs[on] = (calls, {r.uid: list(r.out_tokens) for r in done},
                    eng.stats["device_dispatches"])
    (off, toks_off, n_off), (on, toks_on, n_on) = runs[False], runs[True]
    assert toks_on == toks_off and n_on == n_off
    assert off["scopes"] == 0 and on["scopes"] > 0
    assert off["cpu"] == on["cpu"] == n_off and off["item"] == on["item"] == 0
    wrappers = {name for _, name in _WRAPPED}
    assert {k: v for k, v in off.items() if k in wrappers} == \
        {k: v for k, v in on.items() if k in wrappers}
    assert off.get("stamp_int_gemm", 0) > 0


# ---------------------------------------------------------------------------
# per-site counters and router gauges against the reference
# ---------------------------------------------------------------------------

# The reference's paged engine with quant telemetry on one reduced arch
# (weights and prompts from the pickle ``argv[2] + ".in"``), run in a
# process of its own so that XLA_FLAGS reaches the backend before it starts.
_REFERENCE_TELEMETRY = """
import pickle
import sys
import jax
import jax.numpy as jnp
jax.config.update("jax_platform_name", "cpu")
from repro import configs
from repro.core.stamp import StampConfig
from repro.models import lm as JLM
from repro.serving import kvcache as JKV
from repro.serving.engine import PagedEngineConfig, PagedServingEngine

arch, path = sys.argv[1], sys.argv[2]
with open(path + ".in", "rb") as f:
    params, prompts, engine = pickle.load(f)
serve = JLM.ServeConfig(
    stamp=StampConfig(num_hi_tokens=8, execution="fused"),
    kv=JKV.KVCacheConfig(quantized=True, num_hi=16), quant_telemetry=True)
eng = PagedServingEngine(jax.tree.map(jnp.asarray, params),
                         configs.get_reduced(arch), serve,
                         PagedEngineConfig(**engine))
for p in prompts:
    eng.submit(p, 6)
out = {r.uid: [int(t) for t in r.out_tokens] for r in eng.run()}
with open(path + ".out", "wb") as f:
    pickle.dump((out, eng.metrics.snapshot()), f)
"""


def _telemetry_prompts(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, n) for n in (20, 33, 12)]


@pytest.fixture(scope="module")
def reference_telemetry(tmp_path_factory):
    """Both archs' reference runs, started together at the first use and
    collected when each is read."""
    from repro import configs as JCONFIGS
    root = tmp_path_factory.mktemp("telemetry")
    procs = {}
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_allow_excess_precision=false").strip()
    params = {}
    for arch in TELEMETRY_ARCHS:
        jcfg = JCONFIGS.get_reduced(arch)
        params[arch] = jax.tree.map(
            np.asarray, JLM.init_params(jax.random.PRNGKey(0), jcfg))
        path = str(root / arch)
        with open(path + ".in", "wb") as f:
            pickle.dump((params[arch], _telemetry_prompts(jcfg.vocab_size),
                         PAGED), f)
        procs[arch] = (subprocess.Popen(
            [sys.executable, "-c", _REFERENCE_TELEMETRY, arch, path],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), path)

    def result(arch):
        proc, path = procs[arch]
        log, _ = proc.communicate(timeout=REFERENCE_TIMEOUT_S)
        assert proc.returncode == 0, log[-3000:]
        with open(path + ".out", "rb") as f:
            return pickle.load(f)

    yield result, params
    for proc, _ in procs.values():
        proc.kill()


@pytest.mark.parametrize("arch", TELEMETRY_ARCHS)
def test_quant_counters_and_router_gauges_equal_reference(
        reference_telemetry, arch):
    """Fused STaMP with telemetry on, reduced ``arch``: every
    ``quant_*_total`` counter per site, the MoE router's gauges and its
    dropped-token counter equal the reference's, and so do the tokens."""
    result, params = reference_telemetry
    tcfg = TCONFIGS.get_reduced(arch)
    serve = _tserve(stamp=TStampConfig(num_hi_tokens=8, execution="fused"),
                    quant_telemetry=True)
    eng = TPaged(TLM.from_jax_params(params[arch], tcfg), tcfg, serve,
                 TPagedConfig(**PAGED), device="cpu")
    for p in _telemetry_prompts(tcfg.vocab_size):
        eng.submit(p, 6)
    got = {r.uid: [int(t) for t in r.out_tokens] for r in eng.run()}
    want, snap = result(arch)
    assert got == want
    mine = eng.metrics.snapshot()
    ref_counters = {k: v for k, v in snap["counters"].items()
                    if k.startswith(("quant_", "moe_"))}
    ref_gauges = {k: v for k, v in snap["gauges"].items()
                  if k.startswith("moe_")}
    assert ref_counters and {k: mine["counters"][k]
                             for k in ref_counters} == ref_counters
    assert {k for k in mine["counters"] if k.startswith("quant_")} == \
        {k for k in ref_counters if k.startswith("quant_")}
    assert {k: v for k, v in mine["gauges"].items()
            if k.startswith("moe_")} == ref_gauges
    if tcfg.num_experts:
        assert len(ref_gauges) == tcfg.num_experts + 2
    for k, v in snap["gauges"].items():
        if k.startswith(("quant_clip_rate", "quant_hi_coverage",
                         "quant_sat_rate")):
            assert mine["gauges"][k] == pytest.approx(v, abs=1e-12), k

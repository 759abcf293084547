"""Table 2's runner (``repro_torch.paper.table2_llm``) against the
reference's (``benchmarks/table2_llm.py``) on the CPU.

Both evaluate the same parameters: the port trains ``CFG`` briefly
(``STEPS`` steps of the runner's data and rate, ``WARMUP`` steps of
warmup), and the reference's ``run()`` gets them through its own
``_trained``, whose ``train`` the test replaces with one that records its
arguments and hands them back; both runners' three-call timers run once
(the rows do not depend on them; the reference's file is not touched).

Held: the same row names; each ``sqnr_db`` within ``SQNR_TOL`` (QuaRot
on the reference's signs of ``PRNGKey(1)``, as the other runners' tests
take them), FlatQuant-lite's within ``FLATQUANT_TOL`` (its 100 Adam
steps turn last-bit differences of the loss's gradient into other
trajectories: ``test_torch_paper_core.py`` measured the two fits' final
losses 1.2% apart, and its rows here sit 0.04 dB apart); each perplexity
within ``PPL_REL`` relative (the reference runs its A4 fake quantizers
eagerly, the port in its own op order: 4-bit codes one step apart on a
few tokens move a perplexity, measured 6.8e-4 apart at most, on rows
printed to two decimals), the three perplexities in the reference's
order, and A4 with STaMP apart from A4 uniform by more than ``PPL_REL``
(0.73% apart here), so that the bound cannot hide a perplexity path
that dropped the sequence transform; ``CFG`` and the trainer's
configuration field for field."""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_platform_name", "cpu")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:       # the reference's runners: benchmarks/
    sys.path.insert(0, str(ROOT))

from benchmarks import table2_llm as JT2  # noqa: E402

from repro_torch.launch import train as TTRAIN  # noqa: E402
from repro_torch.paper import run as RUN  # noqa: E402
from repro_torch.paper import table2_llm as TT2  # noqa: E402

# One PyTorch thread a process: the tier-1 run puts six pytest workers on
# the machine's cores, where PyTorch's default of an OpenMP thread per core
# makes each worker's ops wait on the others' (tens of times slower).
torch.set_num_threads(1)

SQNR_TOL = 0.02
FLATQUANT_TOL = 0.1
PPL_REL = 2e-3
STEPS, WARMUP = 40, 4


def _value(derived: str) -> float:
    return float(derived.split("=")[1])


def _to_reference(params: dict) -> dict:
    """The port's parameter dict of ``CFG`` (one attention + MLP layer
    repeated) as the reference's tree: the layers stacked into its
    ``period``."""
    def a(t):
        return jnp.asarray(t.detach().float().numpy())
    layers = params["layers"]
    return {"embed": a(params["embed"]), "final_norm": a(params["final_norm"]),
            "period": ({k: jnp.stack([a(l[k]) for l in layers])
                        for k in layers[0]},)}


@pytest.fixture(scope="module")
def both():
    tc = dataclasses.replace(TT2.TRAIN, steps=STEPS, warmup=WARMUP)
    params = TTRAIN.train(TT2.CFG, tc, verbose=False,
                          device="cpu")["params"]
    jparams = _to_reference(params)
    seen = {}

    def train(cfg, tcfg, ckpt_dir=None, verbose=True):
        seen.update(cfg=cfg, tc=tcfg, ckpt_dir=ckpt_dir)
        return {"params": jparams}

    def once(fn, *args, reps=3):        # the rows do not depend on reps
        return 0.0, fn(*args)

    real, JT2.train = JT2.train, train
    real_timed, JT2.timed = JT2.timed, once
    JT2._trained.cache_clear()
    try:
        ref = JT2.run()
    finally:
        JT2.train, JT2.timed = real, real_timed
        JT2._trained.cache_clear()
    signs = torch.from_numpy(np.array(jax.random.rademacher(
        jax.random.PRNGKey(1), (TT2.CFG.d_model,), dtype=jnp.float32)))
    real_timed, TT2.timed = TT2.timed, lambda fn, *a, device, reps=3: (
        0.0, fn(*a))
    try:
        port = TT2.evaluate(params, "cpu", signs=signs)
    finally:
        TT2.timed = real_timed
    return dict(ref=ref, port=port, seen=seen)


def test_rows_match_reference(both):
    ref, port = both["ref"], both["port"]
    assert [r["name"] for r in port] == [r["name"] for r in ref]
    assert len(port) == 11
    for p, r in zip(port, ref):
        kind = p["derived"].split("=")[0]
        assert kind == r["derived"].split("=")[0]
        got, want = _value(p["derived"]), _value(r["derived"])
        if kind == "sqnr_db":
            tol = FLATQUANT_TOL if "flatquant" in p["name"] else SQNR_TOL
            assert abs(got - want) <= tol, (p["name"], got, want)
        else:
            assert abs(got - want) <= PPL_REL * want, (p["name"], got, want)


def test_stamp_helps_and_quantization_costs(both):
    """The table's claim on these parameters, on the port's rows: STaMP
    raises every method's SQNR, A4 costs perplexity, and STaMP moves A4's
    perplexity by more than ``PPL_REL``; the three perplexities stand in
    the reference's order."""
    rows = {r["name"]: _value(r["derived"]) for r in both["port"]}
    ref = {r["name"]: _value(r["derived"]) for r in both["ref"]}
    for m in TT2.METHODS:
        assert rows[f"table2/{m}+stamp"] > rows[f"table2/{m}"], m
    assert rows["table2/ppl_a4_uniform"] > rows["table2/ppl_fp"]
    ppl = [n for n in rows if "/ppl_" in n]
    assert sorted(ppl, key=rows.get) == sorted(ppl, key=ref.get)
    uni, stamp = rows["table2/ppl_a4_uniform"], rows["table2/ppl_a4_stamp"]
    assert abs(uni - stamp) > PPL_REL * stamp, (uni, stamp)


def test_config_and_trainer_match_reference(both):
    assert dataclasses.asdict(TT2.CFG) == dataclasses.asdict(JT2.CFG)
    assert both["seen"]["cfg"] == JT2.CFG
    assert dataclasses.asdict(TT2.TRAIN) == dataclasses.asdict(
        both["seen"]["tc"])
    assert both["seen"]["ckpt_dir"] is None
    assert TT2.METHODS == JT2.METHODS
    assert "repro_torch.paper.table2_llm" in RUN.MODULES

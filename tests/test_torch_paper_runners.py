"""The port's paper runners (``repro_torch.paper``) against the reference's
(``benchmarks/``) on the CPU, at small sizes.

``quantized_linear_output`` is held against ``benchmarks/common.py``'s for
every method of the tables × every sequence transform.  Each runner's
``run(device="cpu", …)`` at a small size is held against the reference's
rows recomputed there with the reference's own functions: the same row
names, every ``sqnr_db`` within 0.02 dB, QuaRot's rows on the reference's
``jax.random`` signs.  The reference's harness runs under ``jax.jit``, one
compiled program per setting shared by the tests (SVDQuant's with the
weight a constant of the program, so its numpy SVD runs while tracing).
Table 3's block is held against ``jax.jit`` of the reference's block, and
its analytic flop count against XLA's cost analysis of that program.
The reference seeds Table 4's sites with Python's ``hash`` (salted per
process); the port with ``crc32``, which the recomputation uses too."""

import sys
import zlib
from pathlib import Path

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

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:       # the reference's runners: benchmarks/
    sys.path.insert(0, str(ROOT))

from benchmarks import common as JCOM  # noqa: E402
from benchmarks.kernels_bench import stamp_site_bytes  # noqa: E402
from repro.core import quant as JQ  # noqa: E402
from repro.core import transforms as JT  # noqa: E402
from repro.core.calibration import SiteStats, toeplitz_fraction  # noqa: E402
from repro.core.stamp import StampConfig as JStampConfig  # noqa: E402
from repro.core.stamp import stamp_fake_quant  # noqa: E402
from repro.data.pipeline import ar_features  # noqa: E402

from repro_torch.core.stamp import StampConfig as TStampConfig  # noqa: E402
from repro_torch.paper import common as TCOM  # noqa: E402
from repro_torch.paper import (fig3_energy, fig4b_tokens,  # noqa: E402
                               fig7_combinations, run as RUN, table1_lvm,
                               table3_overhead, table4_sites)

HW, D, BATCH, NUM_HI = (8, 8), 32, 2, 8
SQNR_TOL = 0.02

_sqnr_db = jax.jit(JQ.sqnr_db)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _sqnr(derived: str) -> float:
    return float(dict(kv.split("=") for kv in derived.split(","))["sqnr_db"])


def _signs(seed: int, d: int = D):
    key = jax.random.PRNGKey(seed)
    return key, jax.random.rademacher(key, (d,), dtype=jnp.float32)


def _check_rows(port: list, ref: list) -> None:
    """The same names in order, each ``sqnr_db`` within ``SQNR_TOL`` (the
    port's row is printed to 0.01 dB)."""
    assert [r["name"] for r in port] == [r["name"] for r in ref]
    for p, r in zip(port, ref):
        assert abs(_sqnr(p["derived"]) - r["sqnr"]) <= SQNR_TOL, p["name"]


# ---------------------------------------------------------------------------
# the harness of one linear layer
# ---------------------------------------------------------------------------


def _stamps(seq: str):
    """The runners' STaMP settings: Fig. 7's 1-D ones, the tables' 2-D
    DWT."""
    if seq == "none":
        return None, None
    kw = dict(seq_transform=seq, num_hi_tokens=NUM_HI,
              skip_first_token=False)
    if seq == "dwt2d":
        kw.update(levels=3, hw=HW)
    return JStampConfig(**kw), TStampConfig(**kw)


METHODS = ["rtn", "smoothquant", "quarot", "vidit-q", "svdquant"]
SEQS = ["none", "dwt", "dwt2d", "dct", "wht"]


def _grid_setting(method):
    """The Table 1 methods with W4 and per-block scales and calibration
    activations, the others as Fig. 7 runs them."""
    if method in ("vidit-q", "svdquant"):
        return 4, 16, True
    return None, None, False


@pytest.fixture(scope="module")
def layer():
    """Table 1's and Fig. 7's draws at the small size: activations of seed
    0 and calibration activations of seed 1, each with 3 outlier channels,
    and the weight of ``default_rng(0)``."""
    x = JCOM.lvm_activations(batch=BATCH, hw=HW, d=D, seed=0)
    xc = JCOM.lvm_activations(batch=BATCH, hw=HW, d=D, seed=1)
    x, xc = x.at[..., :3].multiply(8.0), xc.at[..., :3].multiply(8.0)
    w = (np.random.default_rng(0).normal(size=(D, D)).astype(np.float32) /
         np.sqrt(D)).astype(np.float32)
    return np.asarray(x), np.asarray(xc), w


@pytest.fixture(scope="module")
def ref_grid(layer):
    """The reference's output for every method × transform (QuaRot on the
    signs of ``PRNGKey(2)``, Fig. 7's), and Table 1's RTN at W4 with
    per-block scales, from one compiled program (the weight a constant of
    it, so SVDQuant's numpy SVD runs while tracing)."""
    x, xc, w = layer
    key = _signs(2)[0]
    wc = jnp.asarray(w)

    def grid(a, c):
        out = {}
        for method in METHODS:
            wb, block, calib = _grid_setting(method)
            for seq in SEQS:
                out[method, seq] = JCOM.quantized_linear_output(
                    a, wc, JCOM.QuantSetting(method, _stamps(seq)[0], 4, wb,
                                             block),
                    x_calib=c if calib else None, key=key)
        for seq in ("none", "dwt2d"):
            out["rtn-w4", seq] = JCOM.quantized_linear_output(
                a, wc, JCOM.QuantSetting("rtn", _stamps(seq)[0], 4, 4, 16),
                x_calib=c)
        return out
    return jax.jit(grid)(jnp.asarray(x), jnp.asarray(xc))


@pytest.mark.parametrize("seq", SEQS)
@pytest.mark.parametrize("method", METHODS)
def test_quantized_linear_output(layer, ref_grid, method, seq):
    """The layer's output within 1e-3 of the reference's (a 4-bit code one
    step apart moves one element by a step of its token) and its SQNR
    within ``SQNR_TOL``."""
    x, xc, w = layer
    wb, block, calib = _grid_setting(method)
    ty = TCOM.quantized_linear_output(
        _t(x), _t(w), TCOM.QuantSetting(method, _stamps(seq)[1], 4, wb,
                                        block),
        x_calib=_t(xc) if calib else None, signs=_t(_signs(2)[1]))
    jy = ref_grid[method, seq]
    assert _rel(jy, ty) <= 1e-3
    ref = x @ w
    assert abs(float(_sqnr_db(jnp.asarray(ref), jy)) -
               float(TCOM.sqnr_row("", 0.0, _t(ref), ty)["derived"]
                     .split("=")[1])) <= SQNR_TOL


# ---------------------------------------------------------------------------
# the runners, each against the reference's loop at the same size
# ---------------------------------------------------------------------------


def _ref_row(name: str, ref, y) -> dict:
    return {"name": name, "sqnr": float(_sqnr_db(ref, y))}


def test_table1(layer, ref_grid):
    """benchmarks/table1_lvm.py's loop at hw (8, 8), d 32, block 16 (its
    2-D DWT setting is ``stamp_2d``'s)."""
    x, _, w = layer
    assert JCOM.stamp_2d(num_hi=NUM_HI, hw=HW) == _stamps("dwt2d")[0]
    ref = []
    for method in table1_lvm.METHODS:
        for use_stamp in (False, True):
            y = ref_grid["rtn-w4" if method == "rtn" else method,
                         "dwt2d" if use_stamp else "none"]
            ref.append(_ref_row(
                f"table1/{method}{'+stamp' if use_stamp else ''}", x @ w, y))
    _check_rows(table1_lvm.run("cpu", hw=HW, d=D, dout=D, batch=BATCH,
                               block=16, num_hi=NUM_HI), ref)


def test_fig3():
    """benchmarks/fig3_energy.py at s 64, d 16, 3 levels: every printed
    fraction equal (the butterflies' profiles by ``energy_profile``'s
    formula over ``jax.jit`` of the reference's transform)."""
    s, d, budgets = 64, 16, (4, 8, 16)
    stats = SiteStats.empty(s, d)
    stats.update(jnp.asarray(ar_features((4, s, d), rho=0.95, seed=0)))
    ref = [f"fraction={toeplitz_fraction(stats.autocorr):.4f}"]
    eye = jnp.eye(s, dtype=jnp.float32)[None]
    for kind in ("klt", "dct", "wht", "dwt"):
        if kind in ("klt", "dct"):
            e = stats.energy_profile(kind, levels=3)
        else:
            m = np.asarray(jax.jit(lambda a: JT.sequence_transform(
                a, kind, levels=3))(eye)[0])
            e = np.einsum("is,st,it->i", m, stats.autocorr, m)
        e = np.sort(e)[::-1]
        ref.append(",".join(f"top{k}={float(e[:k].sum() / e.sum()):.3f}"
                            for k in budgets))
    ref.append(",".join(f"top{k}={k / s:.3f}" for k in budgets))
    rows = fig3_energy.run("cpu", s=s, d=d, batch=4, levels=3,
                           budgets=budgets)
    assert [r["derived"] for r in rows] == ref
    assert [r["name"] for r in rows] == [
        "fig3/toeplitz_fraction", "fig3/energy_klt", "fig3/energy_dct",
        "fig3/energy_wht", "fig3/energy_dwt", "fig3/energy_uniform"]


def test_fig4b():
    """benchmarks/fig4b_tokens.py at hw (8, 8), d 32: the same average
    widths and SQNR within ``SQNR_TOL``."""
    x = JCOM.lvm_activations(batch=BATCH, hw=HW, d=D, seed=0)
    cfgs = [JStampConfig(seq_transform="dwt2d", levels=3, hw=HW,
                         num_hi_tokens=hi, skip_first_token=False)
            for hi in (0, 4, 8, 16)]
    outs = jax.jit(lambda a: [JQ.fake_quant(a, float(b), axis=-1)
                              for b in (4, 5, 6)] +
                   [stamp_fake_quant(a, c) for c in cfgs])(x)
    ref = [_ref_row(f"fig4b/uniform_a{b}", x, y)
           for b, y in zip((4, 5, 6), outs)]
    # the runner's eager rows print as the compiled ones (their elements
    # part in the last bit: XLA turns the range's division by 2^b - 1 into
    # a product)
    for b, r in zip((4, 5, 6), ref):
        eager = float(JQ.sqnr_db(x, JQ.fake_quant(x, float(b), axis=-1)))
        assert f"{eager:.2f}" == f"{r['sqnr']:.2f}"
    for cfg, y in zip(cfgs, outs[3:]):
        row = _ref_row(f"fig4b/stamp_hi{cfg.num_hi_tokens}", x, y)
        row["avg"] = f"avg_bits={cfg.average_bits(64):.3f}"
        ref.append(row)
    rows = fig4b_tokens.run("cpu", hw=HW, d=D, batch=BATCH,
                            num_hi=(0, 4, 8, 16))
    _check_rows(rows, ref)
    for p, r in zip(rows[3:], ref[3:]):
        assert p["derived"].startswith(r["avg"])


def test_fig7(layer, ref_grid):
    """benchmarks/fig7_combinations.py at hw (8, 8), d 32, QuaRot on the
    reference's signs of ``PRNGKey(2)``."""
    x, _, w = layer
    ref = []
    for feat in fig7_combinations.FEATURES:
        for seq in fig7_combinations.SEQUENCES:
            assert _stamps(seq)[0] == (None if seq == "none" else
                                       JStampConfig(seq_transform=seq,
                                                    num_hi_tokens=NUM_HI,
                                                    skip_first_token=False))
            ref.append(_ref_row(f"fig7/{feat}+{seq}", x @ w,
                                ref_grid[feat, seq]))
    _check_rows(fig7_combinations.run("cpu", hw=HW, d=D, dout=D,
                                      batch=BATCH, num_hi=NUM_HI,
                                      signs=_t(_signs(2)[1])), ref)


def test_table4():
    """benchmarks/table4_sites.py's ablation at hw (8, 8), d 32 (QuaRot on
    the signs of ``PRNGKey(3)``), then the fused-site rows at 160 rows:
    the reference's names and ``stamp_site_bytes`` counts, and each fused
    output within 1e-4 of the port's reference path and within 1e-5 of
    the reference's."""
    w = jnp.asarray(np.random.default_rng(1).normal(size=(D, D)).astype(
        np.float32) / np.sqrt(D))
    key, signs = _signs(3)
    xs = {}
    for site in table4_sites.SITES:
        if site == "attn2.to_out":
            xs[site] = jnp.asarray(np.random.default_rng(3).normal(
                size=(BATCH, 64, D)).astype(np.float32))
        else:
            xs[site] = JCOM.lvm_activations(
                batch=BATCH, hw=HW, d=D, seed=zlib.crc32(site.encode()) % 1000)
    stamp = JStampConfig(seq_transform="dwt2d", levels=3, hw=HW,
                         num_hi_tokens=NUM_HI, skip_first_token=False)

    def ablation(xs):
        return {(site, tf): JCOM.quantized_linear_output(
            x, w, JCOM.QuantSetting("quarot" if "quarot" in tf else "rtn",
                                    stamp if "stamp" in tf else None, 4,
                                    None), key=key)
            for site, x in xs.items() for tf in table4_sites.TRANSFORMS}
    ys = jax.jit(ablation)(xs)
    ref = [_ref_row(f"table4/{site}/{tf}", xs[site] @ w, ys[site, tf])
           for site in table4_sites.SITES for tf in table4_sites.TRANSFORMS]
    rows = table4_sites.run("cpu", hw=HW, d=D, dout=D, batch=BATCH,
                            num_hi=NUM_HI, fused_s=160, fused_d=32,
                            signs=_t(signs))
    _check_rows(rows[:len(ref)], ref)
    sites = table4_sites.fused_sites(torch.device("cpu"), s=160, d=32)
    fused = rows[len(ref):]
    assert len(fused) == 2 * len(sites) == 12
    for site, r_ref, r_fused in zip(sites, fused[::2], fused[1::2]):
        dual = site["name"] == "mlp.gate_up"
        din, dout = {"attn.qkv": (32, 64), "attn.out_proj": (32, 32),
                     "mlp.gate_up": (32, 64), "mlp.down_proj": (64, 32),
                     "mamba.in_proj": (32, 208),
                     "mamba.out_proj": (64, 32)}[site["name"]]
        rb, fb = stamp_site_bytes(160, din, dout, dual=dual)
        assert table4_sites.stamp_site_bytes(160, din, dout, dual) == (rb, fb)
        assert r_ref["name"] == f"kernels/site/{site['name']}/reference"
        assert r_ref["derived"] == f"hbm_bytes={rb}"
        assert r_fused["derived"] == (f"hbm_bytes={fb},"
                                      f"hbm_savings={rb / fb:.2f}x")
        assert _rel(site["ref"], site["fused"]) <= 1e-4


def test_fused_site_reference_path_matches_reference():
    """The fused rows' reference path (STaMP on the dequantized prepared
    weights) against the reference's, on the out-proj's head-split
    input."""
    from repro.core import stamp as JS
    from repro_torch.core import stamp as TS
    rng = np.random.default_rng(7)
    x = rng.normal(size=(1, 160, 4, 8)).astype(np.float32)
    w = (rng.normal(size=(32, 32)) * .05).astype(np.float32)
    jy = jax.jit(lambda a, b: JS.stamp_linear(
        a, JS.prepare_linear(b).dequant(jnp.float32), None,
        JS.StampConfig(num_hi_tokens=64), merge_heads=True))(
            jnp.asarray(x), jnp.asarray(w))
    ty = TS.stamp_linear(_t(x), TS.prepare_linear(_t(w)).dequant(
                             torch.float32), None,
                         TS.StampConfig(num_hi_tokens=64), merge_heads=True)
    assert _rel(jy, ty) <= 1e-5


# ---------------------------------------------------------------------------
# Table 3: the block and its flop count
# ---------------------------------------------------------------------------


def _ref_block(transform):
    """The reference's block (``benchmarks/table3_overhead._block_flops``'s
    ``fwd``)."""
    def fwd(x, w1, w2):
        h = x
        if transform in ("feat_hadamard", "both"):
            h = JT.wht(h, axis=-1)
        if transform in ("seq_dwt", "both"):
            h = JT.haar_dwt(h, levels=3)
        if transform == "seq_hadamard":
            h = JT.wht(h, axis=-2)
        y = jax.nn.silu(h @ w1) @ w2
        if transform in ("seq_dwt", "both"):
            y = JT.haar_idwt(y, levels=3)
        if transform == "seq_hadamard":
            y = JT.iwht(y, axis=-2)
        if transform in ("feat_hadamard", "both"):
            y = JT.iwht(y, axis=-1)
        return y
    return fwd


def test_table3():
    """At (2, 64, 128): every block within 1e-5 of ``jax.jit`` of the
    reference's, run through the kernel wrappers (their plain versions
    here) and through the plain transforms alike; the analytic overhead
    within 0.01 percentage points of XLA's count of the reference's
    program; the reference's row names."""
    b, d = 2, 128
    x = TCOM.lvm_activations(b, HW, d, seed=0)
    w1, w2 = table3_overhead.block_weights(d, "cpu")
    from repro_torch.kernels import haar_dwt as K9
    from repro_torch.kernels import wht as K10
    base = None
    for tf in ("none",) + table3_overhead.TRANSFORMS:
        compiled = jax.jit(_ref_block(tf)).lower(
            jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2)).compile()
        jy = compiled(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2))
        cost = compiled.cost_analysis()
        flops = (cost[0] if isinstance(cost, list) else cost)["flops"]
        ty = table3_overhead.block_forward(tf, x, w1, w2)
        assert _rel(jy, ty) <= 1e-5, tf
        plain = table3_overhead.block_forward(tf, x, w1, w2,
                                              dwt=K9.haar_dwt_plain,
                                              wht=K10.wht_plain)
        assert torch.equal(plain, ty)
        if tf == "none":
            base = flops
            continue
        ours = table3_overhead.block_flops
        pct = (ours(tf, b, 64, d) - ours("none", b, 64, d)) / \
            ours("none", b, 64, d) * 100
        assert abs(pct - (flops - base) / base * 100) <= 0.01, tf
    rows = table3_overhead.run("cpu", hw=HW, d=d, batch=b)
    assert [r["name"] for r in rows] == [
        "table3/baseline", "table3/feat_hadamard", "table3/seq_hadamard",
        "table3/seq_dwt", "table3/both"]


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


def test_run_prints_the_csv(monkeypatch, capsys):
    monkeypatch.setattr(RUN, "MODULES", ["repro_torch.paper.fig3_energy"])
    RUN.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert [ln.split(",")[0] for ln in lines[1:]] == [
        "fig3/toeplitz_fraction", "fig3/energy_klt", "fig3/energy_dct",
        "fig3/energy_wht", "fig3/energy_dwt", "fig3/energy_uniform"]


def test_entry_points_refuse_a_missing_card():
    """Without ``--device cpu`` the entry points run on ``cuda``; with no
    card they raise before any work, and nothing falls back to the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs none")
    from repro_torch.paper import quickstart
    for main in (RUN.main, quickstart.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        table1_lvm.run()

import itertools
import sys

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers", "chaos: deterministic fault-injection suite (own CI "
                   "step; tier-1 runs with -m 'not chaos')")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card and nvcc (the port's kernels); "
                   "skips elsewhere")


# ---------------------------------------------------------------------------
# hypothesis fallback
# ---------------------------------------------------------------------------
# `hypothesis` is a dev-only dependency (requirements-dev.txt) that is absent
# from the minimal runtime image; without a guard its import breaks
# *collection* of three test modules.  Rather than skipping those modules
# wholesale, install a deterministic micro-shim that evaluates each @given
# property on a small fixed grid of examples drawn from the declared
# strategies.  The real library (when installed) always takes precedence.

try:  # pragma: no cover - exercised only when hypothesis exists
    import hypothesis  # noqa: F401
except ImportError:
    import types

    class _Strategy:
        def __init__(self, values):
            self.values = list(values)

    def _integers(min_value=0, max_value=10):
        lo, hi = int(min_value), int(max_value)
        span = hi - lo
        pts = sorted({lo, lo + span // 3, lo + (2 * span) // 3, hi})
        return _Strategy(pts)

    def _sampled_from(elements):
        return _Strategy(elements)

    def _booleans():
        return _Strategy([False, True])

    def _given(**strategies):
        names = list(strategies)
        cases = list(itertools.product(*(strategies[n].values
                                         for n in names)))
        argnames = ",".join(names)
        argvalues = cases if len(names) > 1 else [c[0] for c in cases]
        return pytest.mark.parametrize(argnames, argvalues)

    def _settings(**_ignored):
        # deadline/max_examples are hypothesis runtime knobs; the shim's
        # fixed grid is small enough that they can be ignored.
        def deco(fn):
            return fn
        return deco

    _st = types.ModuleType("hypothesis.strategies")
    _st.integers = _integers
    _st.sampled_from = _sampled_from
    _st.booleans = _booleans

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.strategies = _st
    _hyp.__shim__ = True

    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st

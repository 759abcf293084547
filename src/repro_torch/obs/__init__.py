"""Observability of the port (the twin of ``repro.obs``): metrics registry,
structured event trace with Chrome / Perfetto export, and STaMP
quantization-health telemetry.

* `metrics.py` — pure stdlib.  `MetricsRegistry` with typed counters,
  gauges and fixed-bucket histograms, labeled children, ``snapshot()`` /
  ``reset()`` and JSON + Prometheus-text exposition; both serving engines
  hang their ``stats`` surface off one registry.
* `trace.py` — pure stdlib.  The :class:`Event` record of the engines'
  event rings, the :class:`StepTimer` of the step phases, and
  `export_chrome_trace`.
* `quantstats.py` — torch.  Per-STaMP-site clip rate, hi-token coverage,
  scale range and saturation counts, reduced on the step's device and
  moved to the host with the step's token ids in one transfer.
"""

from repro_torch.obs.metrics import (LATENCY_BUCKETS,  # noqa: F401
                                     MetricsRegistry, exponential_buckets)
from repro_torch.obs.trace import (Event, StepTimer,  # noqa: F401
                                   export_chrome_trace)

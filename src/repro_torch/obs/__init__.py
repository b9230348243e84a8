"""``repro_torch.obs`` — the host half of the reference's observability
layer (``repro.obs``), for the compiled EL stack on the card.

  * **span/trace layer** (:mod:`repro_torch.obs.trace`) —
    ``trace.span("cohort.wave")`` timed host scopes, each a
    ``torch.profiler.record_function`` (and an NVTX range once CUDA is
    up), streamed as structured JSONL;
  * **metrics registry + exposition** (:mod:`repro_torch.obs.metrics`) —
    counters/gauges/histograms rendered as Prometheus text + JSON via
    ``ELReport.telemetry``, ``FleetServer.stats()`` and the launchers'
    ``--metrics-out``;
  * the shared bench **timing helpers** (:mod:`repro_torch.obs.timing`)
    and the launchers' flags (:mod:`repro_torch.obs.cli`).

The in-graph telemetry rings (``repro.obs.rings``), program profiles
(``repro.obs.prof``) and the bench-regression bookkeeping
(``repro.obs.regress``) are ROADMAP Queue 1 item 12's remainder.
``repro_torch.obs`` never imports ``repro_torch.el`` — the EL runtime
imports obs (lazily where it is hot), so there is no cycle.
"""

from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, parse_prometheus,
                                     registry_from_fleet,
                                     registry_from_report,
                                     spans_into_registry,
                                     write_metrics_files)
from repro_torch.obs.timing import (TimedBlock, repeat_s, summarize_ns,
                                    time_block, timeit_us)
from repro_torch.obs.trace import (Tracer, configure, event, get_tracer,
                                   read_jsonl, span, use_tracer)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "parse_prometheus", "registry_from_fleet", "registry_from_report",
    "spans_into_registry", "write_metrics_files",
    "TimedBlock", "repeat_s", "summarize_ns", "time_block", "timeit_us",
    "Tracer", "configure", "event", "get_tracer", "read_jsonl", "span",
    "use_tracer",
]

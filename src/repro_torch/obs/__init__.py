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
  * the **device telemetry rings** (:mod:`repro_torch.obs.rings`) —
    per-round / per-event signals recorded inside the device loops, with
    no host sync, returned as ``out["telemetry"]``;
  * **program profiles** (:mod:`repro_torch.obs.prof`) — each compiled
    program's buffer bytes, chunk scratch peak and matmul work, and the
    collective / aliasing contracts checked before a run;
  * the **bench-regression bookkeeping** (:mod:`repro_torch.obs.regress`)
    — history JSONL, the ledger of known regressions, the gate's
    comparisons;
  * the shared bench **timing helpers** (:mod:`repro_torch.obs.timing`)
    and the launchers' flags (:mod:`repro_torch.obs.cli`).

``repro_torch.obs`` never imports ``repro_torch.el`` — the EL runtime
imports obs (lazily where it is hot), so there is no cycle.
"""

from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, parse_prometheus,
                                     registry_from_fleet,
                                     registry_from_report,
                                     spans_into_registry,
                                     write_metrics_files)
from repro_torch.obs.prof import (CollectiveContract, ContractViolation,
                                  ProgramProfile, default_contract,
                                  param_tree_bytes, profile_jit)
from repro_torch.obs.regress import (Finding, LedgerEntry, append_history,
                                     check_ledger, compare_ratios,
                                     compare_to_baseline, load_history,
                                     load_ledger, worst_exit_code)
from repro_torch.obs.rings import (TelemetrySpec, as_spec,
                                   async_reference_telemetry, ring_order,
                                   sync_reference_telemetry, unroll_ring)
from repro_torch.obs.timing import (TimedBlock, repeat_s, summarize_ns,
                                    time_block, timeit_us)
from repro_torch.obs.trace import (Tracer, configure, event, get_tracer,
                                   read_jsonl, span, use_tracer)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "parse_prometheus", "registry_from_fleet", "registry_from_report",
    "spans_into_registry", "write_metrics_files",
    "CollectiveContract", "ContractViolation", "ProgramProfile",
    "default_contract", "param_tree_bytes", "profile_jit",
    "Finding", "LedgerEntry", "append_history", "check_ledger",
    "compare_ratios", "compare_to_baseline", "load_history",
    "load_ledger", "worst_exit_code",
    "TelemetrySpec", "as_spec", "async_reference_telemetry",
    "ring_order", "sync_reference_telemetry", "unroll_ring",
    "TimedBlock", "repeat_s", "summarize_ns", "time_block", "timeit_us",
    "Tracer", "configure", "event", "get_tracer", "read_jsonl", "span",
    "use_tracer",
]

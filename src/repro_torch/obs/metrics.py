"""Metrics registry + exposition: counters/gauges/histograms per run,
rendered as Prometheus text format and JSON.

A copy of the reference's ``repro.obs.metrics`` (pure Python), every
message kept, so one registry renders the same text and JSON in both
packages.  The tracer (``repro_torch.obs.trace``) supplies span
durations and ``ELReport.telemetry`` the compile-cache counters, the
program profile and the device rings; a :class:`MetricsRegistry` folds
them into a flat, scrapable snapshot, which ``--metrics-out`` on the
launchers writes.

Deliberately tiny and dependency-free: enough of the Prometheus
`text exposition format <https://prometheus.io/docs/instrumenting/exposition_formats/>`_
(``# HELP`` / ``# TYPE``, labels, cumulative histogram buckets) for a
real scraper to ingest, plus :func:`parse_prometheus` so CI can assert
the output round-trips.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

#: default histogram buckets (seconds-ish scale; µs spans divide first)
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0)


def _labels_key(labels: Optional[Mapping[str, str]]
                ) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v))
                        for k, v in (labels or {}).items()))


def _escape_label(v: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote and
    newline (exposition-format spec, in that order so the escapes
    themselves survive)."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _unescape_label(v: str) -> str:
    out: List[str] = []
    i = 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append({"n": "\n", '"': '"', "\\": "\\"}.get(nxt, c + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _fmt_labels(items: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{k}="{_escape_label(v)}"' for k, v in items]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


@dataclasses.dataclass
class Counter:
    """Monotonic counter; one value per label set."""

    name: str
    help: str
    values: Dict[Tuple[Tuple[str, str], ...], float] = \
        dataclasses.field(default_factory=dict)

    def inc(self, amount: float = 1.0,
            labels: Optional[Mapping[str, str]] = None) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        k = _labels_key(labels)
        self.values[k] = self.values.get(k, 0.0) + float(amount)


@dataclasses.dataclass
class Gauge:
    """Point-in-time value; one value per label set."""

    name: str
    help: str
    values: Dict[Tuple[Tuple[str, str], ...], float] = \
        dataclasses.field(default_factory=dict)

    def set(self, value: float,
            labels: Optional[Mapping[str, str]] = None) -> None:
        self.values[_labels_key(labels)] = float(value)


@dataclasses.dataclass
class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics)."""

    name: str
    help: str
    buckets: Tuple[float, ...] = DEFAULT_BUCKETS
    counts: Dict[Tuple[Tuple[str, str], ...], List[int]] = \
        dataclasses.field(default_factory=dict)
    sums: Dict[Tuple[Tuple[str, str], ...], float] = \
        dataclasses.field(default_factory=dict)
    totals: Dict[Tuple[Tuple[str, str], ...], int] = \
        dataclasses.field(default_factory=dict)

    def observe(self, value: float,
                labels: Optional[Mapping[str, str]] = None) -> None:
        k = _labels_key(labels)
        if k not in self.counts:
            self.counts[k] = [0] * len(self.buckets)
            self.sums[k] = 0.0
            self.totals[k] = 0
        v = float(value)
        for i, le in enumerate(self.buckets):
            if v <= le:
                self.counts[k][i] += 1
        self.sums[k] += v
        self.totals[k] += 1

    def observe_many(self, values: Sequence[float],
                     labels: Optional[Mapping[str, str]] = None) -> None:
        for v in values:
            self.observe(v, labels)


class MetricsRegistry:
    """A named family of counters/gauges/histograms with renderers.

    ``counter()``/``gauge()``/``histogram()`` create-or-return (same
    name must keep the same type), so builders can compose registries
    incrementally — e.g. the fleet CLI folds per-tenant report metrics
    and server stats into one registry before writing files.
    """

    def __init__(self) -> None:
        self._metrics: Dict[str, Any] = {}

    def _register(self, cls, name: str, help: str, **kw) -> Any:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        m = self._metrics.get(name)
        if m is None:
            m = cls(name=name, help=help, **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS
                  ) -> Histogram:
        return self._register(Histogram, name, help, buckets=buckets)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __getitem__(self, name: str) -> Any:
        return self._metrics[name]

    # -- renderers -----------------------------------------------------------

    def render_prometheus(self) -> str:
        """The registry in Prometheus text exposition format."""
        lines: List[str] = []
        for name in self.names():
            m = self._metrics[name]
            kind = {Counter: "counter", Gauge: "gauge",
                    Histogram: "histogram"}[type(m)]
            lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {kind}")
            if isinstance(m, Histogram):
                for k in sorted(m.counts):
                    for le, c in zip(m.buckets, m.counts[k]):
                        le_lab = 'le="' + _fmt_value(le) + '"'
                        lines.append(
                            f"{name}_bucket{_fmt_labels(k, le_lab)} {c}")
                    inf_lab = 'le="+Inf"'
                    lines.append(
                        f"{name}_bucket{_fmt_labels(k, inf_lab)}"
                        f" {m.totals[k]}")
                    lines.append(
                        f"{name}_sum{_fmt_labels(k)}"
                        f" {_fmt_value(m.sums[k])}")
                    lines.append(
                        f"{name}_count{_fmt_labels(k)} {m.totals[k]}")
            else:
                for k in sorted(m.values):
                    lines.append(
                        f"{name}{_fmt_labels(k)}"
                        f" {_fmt_value(m.values[k])}")
        return "\n".join(lines) + "\n"

    def to_json(self) -> Dict[str, Any]:
        """A JSON-safe snapshot (the ``--metrics-out`` ``.json`` file)."""
        out: Dict[str, Any] = {}
        for name in self.names():
            m = self._metrics[name]
            if isinstance(m, Histogram):
                out[name] = {
                    "type": "histogram", "help": m.help,
                    "buckets": list(m.buckets),
                    "series": [
                        {"labels": dict(k), "counts": m.counts[k],
                         "sum": m.sums[k], "count": m.totals[k]}
                        for k in sorted(m.counts)],
                }
            else:
                kind = "counter" if isinstance(m, Counter) else "gauge"
                out[name] = {
                    "type": kind, "help": m.help,
                    "series": [{"labels": dict(k), "value": v}
                               for k, v in sorted(m.values.items())],
                }
        return out


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)\s*$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> Dict[str, List[Dict[str, Any]]]:
    """Parse Prometheus text format back into
    ``{name: [{"labels": {...}, "value": float}, ...]}`` — strict on
    sample lines (raises ``ValueError`` on malformed ones), which is
    exactly what the CI smoke wants from ``--metrics-out`` output.
    Histogram series parse as their ``_bucket``/``_sum``/``_count``
    sample names.
    """
    samples: Dict[str, List[Dict[str, Any]]] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(
                f"malformed Prometheus sample on line {lineno}: {line!r}")
        raw = m.group("value")
        value = float("inf") if raw == "+Inf" else (
            float("-inf") if raw == "-Inf" else float(raw))
        labels = {k: _unescape_label(v)
                  for k, v in _LABEL_RE.findall(m.group("labels") or "")}
        samples.setdefault(m.group("name"), []).append(
            {"labels": labels, "value": value})
    return samples


# ---------------------------------------------------------------------------
# Registry builders (ELReport / fleet stats → metrics)
# ---------------------------------------------------------------------------


def registry_from_report(report, *, registry: Optional[MetricsRegistry]
                         = None,
                         labels: Optional[Mapping[str, str]] = None
                         ) -> MetricsRegistry:
    """Fold one :class:`repro_torch.el.report.ELReport` into a registry.

    Emits run-level gauges/counters (rounds, final metric, consumption,
    wall time, per-arm pulls), the compile-cache counters when
    ``report.telemetry['cache']`` is present, program-profile gauges
    (``el_profile_*``: flops, peak live bytes, the per-op collective
    census) when ``report.telemetry['profile']`` is present, and
    ring-derived series (budget remaining, per-round cost / merge-α
    histograms) when the run recorded the device rings.
    """
    reg = registry if registry is not None else MetricsRegistry()
    labels = dict(labels or {})
    base = {"mode": report.mode or "?", "policy": report.policy or "?",
            **labels}
    reg.counter("el_rounds_total",
                "global aggregations completed").inc(
        report.n_aggregations, base)
    reg.gauge("el_final_metric", "final eval metric").set(
        report.final_metric, base)
    reg.gauge("el_total_consumed",
              "total resource units consumed").set(
        report.total_consumed, base)
    reg.gauge("el_wall_time", "simulated wall-clock at termination").set(
        report.wall_time, base)
    reg.gauge("el_elapsed_seconds", "host wall seconds for the run").set(
        report.elapsed_s, base)
    for arm, pulls in enumerate(report.arm_pulls or []):
        reg.counter("el_arm_pulls_total", "bandit pulls per arm").inc(
            pulls, {**base, "arm": str(arm + 1)})

    tele = report.telemetry or {}
    cache = tele.get("cache")
    if cache:
        for k in ("hits", "misses", "evictions"):
            if k in cache:
                reg.counter(f"el_program_cache_{k}_total",
                            f"compiled-program cache {k}").inc(
                    cache[k], labels)
        if "entries" in cache:
            reg.gauge("el_program_cache_entries",
                      "compiled programs cached").set(
                cache["entries"], labels)
    prof = tele.get("profile")
    if prof:
        _profile_gauges = (
            ("flops", "XLA cost-analysis flops per dispatch"),
            ("bytes_accessed", "XLA cost-analysis bytes accessed"),
            ("argument_bytes", "per-device argument bytes"),
            ("output_bytes", "per-device output bytes"),
            ("temp_bytes", "per-device temp bytes"),
            ("alias_bytes", "donated/aliased input bytes"),
            ("peak_live_bytes",
             "arguments + outputs + temps - aliased, per device"),
            ("generated_code_bytes", "compiled executable code size"),
            ("collective_bytes",
             "per-device bytes moved by collectives per dispatch"),
            ("hlo_lines", "optimized HLO line count"),
        )
        for field, help_ in _profile_gauges:
            v = prof.get(field)
            if v is not None:
                reg.gauge(f"el_profile_{field}", help_).set(
                    float(v), base)
        for op, d in sorted((prof.get("collectives") or {}).items()):
            op_labels = {**base, "op": op}
            reg.gauge("el_profile_collectives",
                      "collective op census of the compiled program"
                      ).set(float(d.get("count", 0)), op_labels)
            reg.gauge("el_profile_collective_op_bytes",
                      "per-device result bytes of one collective op"
                      ).set(float(d.get("bytes", 0)), op_labels)
    rings = tele.get("rings")
    if rings:
        from repro_torch.obs.rings import unroll_ring
        rings = unroll_ring(rings)     # round order, written slots only
        resid = np.asarray(rings["budget_resid"], np.float64)
        if resid.size:
            reg.gauge("el_budget_remaining",
                      "min residual budget after the last recorded "
                      "round").set(float(resid[-1]), base)
        cost_key = "round_cost" if "round_cost" in rings else "cost"
        costs = np.asarray(rings[cost_key], np.float64)
        if costs.size:
            reg.histogram(
                "el_round_cost", "charged cost per round/event",
                buckets=_cost_buckets(costs)).observe_many(costs, base)
        if "alpha" in rings:
            reg.histogram(
                "el_merge_alpha", "async staleness-weighted merge rate",
                buckets=(0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.75, 1.0)
            ).observe_many(np.asarray(rings["alpha"], np.float64), base)
        if "interarrival" in rings:
            inter = np.asarray(rings["interarrival"], np.float64)
            reg.histogram(
                "el_event_interarrival",
                "simulated time between async merge events",
                buckets=_cost_buckets(inter)).observe_many(inter, base)
        if "active_edges" in rings:
            # scenario-engine columns (repro_torch.el.scenarios): fleet-churn
            # census per recorded round/event
            act = np.asarray(rings["active_edges"], np.float64)
            if act.size:
                reg.gauge("el_scenario_active_edges",
                          "active edges in the last recorded "
                          "round/event").set(float(act[-1]), base)
            reg.counter("el_scenario_dropouts_total",
                        "edge dropout transitions over the recorded "
                        "window").inc(
                int(np.sum(np.asarray(rings["dropouts"], np.int64))),
                base)
            reg.counter("el_scenario_rejoins_total",
                        "edge rejoin transitions over the recorded "
                        "window").inc(
                int(np.sum(np.asarray(rings["rejoins"], np.int64))),
                base)
    return reg


def _cost_buckets(values: np.ndarray) -> Tuple[float, ...]:
    """Data-scaled buckets: powers of two spanning the sample range (the
    EL cost scale depends entirely on the config's comp/comm costs)."""
    hi = float(np.max(values)) if values.size else 1.0
    if hi <= 0:
        return (1.0,)
    top = 2.0 ** math.ceil(math.log2(hi))
    return tuple(top / 2.0 ** i for i in reversed(range(8)))


def registry_from_fleet(stats: Mapping[str, Any],
                        *, registry: Optional[MetricsRegistry] = None
                        ) -> MetricsRegistry:
    """Fold ``FleetServer.stats()`` into a registry."""
    reg = registry if registry is not None else MetricsRegistry()
    counters = ("tenants_submitted", "tenants_done", "compiles", "waves",
                "cache_hits", "cache_misses", "cache_evictions")
    for k in counters:
        if k in stats:
            reg.counter(f"fleet_{k}_total", f"fleet server {k}").inc(
                stats[k])
    for k in ("tenants_pending", "tenants_active", "cohorts"):
        if k in stats:
            reg.gauge(f"fleet_{k}", f"fleet server {k}").set(stats[k])
    return reg


def spans_into_registry(events: Sequence[Mapping[str, Any]],
                        *, registry: Optional[MetricsRegistry] = None
                        ) -> MetricsRegistry:
    """Fold tracer span records (``repro_torch.obs.trace``) into
    per-span-name duration histograms (seconds) + event counters."""
    reg = registry if registry is not None else MetricsRegistry()
    for ev in events:
        name = str(ev.get("name", "?")).replace(".", "_")
        if ev.get("ev") == "span":
            reg.histogram(f"obs_span_{name}_seconds",
                          f"wall duration of {ev.get('name')} spans"
                          ).observe(float(ev.get("dur_us", 0.0)) / 1e6)
        else:
            reg.counter(f"obs_event_{name}_total",
                        f"{ev.get('name')} events").inc()
    return reg


def write_metrics_files(registry: MetricsRegistry, path: str,
                        *, spans_jsonl: Optional[str] = None) -> List[str]:
    """Write the ``--metrics-out`` artifact set: ``path`` (Prometheus
    text) and ``path + '.json'`` (JSON snapshot).  Returns the paths
    written; ``spans_jsonl`` (the tracer's sink, already on disk) is
    appended to the returned list for the CLI summary line."""
    with open(path, "w") as f:
        f.write(registry.render_prometheus())
    json_path = path + ".json"
    with open(json_path, "w") as f:
        json.dump(registry.to_json(), f, indent=2, sort_keys=True)
    written = [path, json_path]
    if spans_jsonl:
        written.append(spans_jsonl)
    return written

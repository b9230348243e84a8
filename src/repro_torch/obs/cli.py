"""argparse glue shared by the ``repro_torch.launch`` CLIs.

One flag set, one lifecycle, three launchers::

    add_metrics_args(ap)                 # --metrics-out [--trace-dir]
    begin_observability(args)            # arm the JSONL sink / profiler
    ... run ...
    finish_observability(args, registry) # flush + write the artifact set

``--metrics-out PATH`` writes three files: ``PATH`` (Prometheus text
exposition), ``PATH.json`` (the same registry as JSON) and
``PATH.spans.jsonl`` (every span/event the tracer saw, streamed live).
``--trace-dir DIR`` additionally records a ``torch.profiler`` trace of
the whole run (host activity, and the card's when the run is on CUDA)
and writes it into ``DIR`` as a Chrome trace — the ``trace.span``
scopes appear as ``record_function`` rows beside the card's kernels.
The reference (``repro.obs.cli``) records a ``jax.profiler`` trace.
"""

from __future__ import annotations

import os

import torch

#: the file ``--trace-dir`` writes (open it in ui.perfetto.dev or
#: chrome://tracing)
TRACE_FILE = "trace.json"


def add_metrics_args(ap, *, trace_dir: bool = False) -> None:
    """Add the observability flags to an ``argparse`` parser."""
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write run metrics to PATH (Prometheus text), "
                         "PATH.json (JSON snapshot) and PATH.spans.jsonl "
                         "(streamed tracer spans)")
    if trace_dir:
        ap.add_argument("--trace-dir", default=None, metavar="DIR",
                        help="record a torch.profiler trace of the run "
                             f"into DIR/{TRACE_FILE} (inspect with "
                             "ui.perfetto.dev or chrome://tracing)")


def _on_card(args) -> bool:
    """Whether the run's device (``--device``, default CUDA) is a card."""
    dev = torch.device(getattr(args, "device", None) or "cuda")
    return dev.type == "cuda" and torch.cuda.is_available()


def begin_observability(args) -> bool:
    """Arm the sinks BEFORE the run: swap in a tracer streaming to
    ``PATH.spans.jsonl`` and (with ``--trace-dir``) start a
    ``torch.profiler`` session, kept on ``args`` until
    :func:`finish_observability`.  Returns whether ``--metrics-out`` is
    active."""
    if getattr(args, "metrics_out", None):
        from repro_torch.obs import trace
        trace.configure(jsonl_path=args.metrics_out + ".spans.jsonl")
    if getattr(args, "trace_dir", None):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if _on_card(args):
            activities.append(ProfilerActivity.CUDA)
        args.profiler = profile(activities=activities)
        args.profiler.start()
    return bool(getattr(args, "metrics_out", None))


def finish_observability(args, registry=None):
    """Flush at the end of the run: stop the profiler and write its
    trace, fold the buffered spans/events into ``registry`` (a fresh one
    when ``None``) and write the ``--metrics-out`` artifact set.  No-op
    for flags that were not passed; returns the registry written (or
    ``None``)."""
    prof = getattr(args, "profiler", None)
    if prof is not None:
        prof.stop()
        args.profiler = None
        os.makedirs(args.trace_dir, exist_ok=True)
        path = os.path.join(args.trace_dir, TRACE_FILE)
        prof.export_chrome_trace(path)
        print(f"profiler trace written to {path}", flush=True)
    if not getattr(args, "metrics_out", None):
        return None
    from repro_torch.obs.metrics import (MetricsRegistry, spans_into_registry,
                                         write_metrics_files)
    from repro_torch.obs.trace import get_tracer
    reg = registry if registry is not None else MetricsRegistry()
    tracer = get_tracer()
    spans_into_registry(tracer.events(), registry=reg)
    written = write_metrics_files(reg, args.metrics_out,
                                  spans_jsonl=tracer.jsonl_path)
    tracer.close()
    print("metrics written: " + ", ".join(written), flush=True)
    return reg


def telemetry_arg(ap) -> None:
    """Add ``--telemetry [N]``: switch the device rings on, optionally
    with an explicit ring length (bare flag = the default ring)."""
    ap.add_argument("--telemetry", nargs="?", type=int, const=True,
                    default=None, metavar="RING",
                    help="record the device telemetry rings "
                         "(repro_torch.obs.rings); optional ring length, "
                         "default 128")


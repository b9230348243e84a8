"""Host-side span/trace layer: timed scopes + structured JSONL events.

Everything around the compiled programs — session builds, program
dispatches, fleet waves, admission refills, cache lookups — is host
work, traced here:

    from repro_torch.obs import trace

    with trace.span("cohort.wave", cohort=0, slots_active=3):
        ...

A span times its block on the host clock (``perf_counter_ns``; it never
synchronises the card), enters a ``torch.profiler.record_function`` of
the same name and, once CUDA is initialised, an NVTX range — so under a
profiler trace (``--trace-dir`` on the launchers, or
``torch.profiler.profile``) or ``nsys`` the host scopes line up with the
card's timeline — and records a structured event on the process-wide
:class:`Tracer`.  ``configure(jsonl_path=...)`` additionally streams
every event as one JSON line; the default tracer keeps a bounded
in-memory buffer so tracing is always on and never grows without bound.
The reference (``repro.obs.trace``) enters a
``jax.profiler.TraceAnnotation`` in the same place.

Spans sit around dispatches, never inside a CUDA graph's capture or
replay (``repro_torch.el.ingraph.ChunkRunner._run_chunk``), whose
region records no host call.

Events are plain dicts::

    {"ev": "span", "name": "cohort.wave", "ts": <unix seconds>,
     "dur_us": 812.4, "slots_active": 3, ...}
    {"ev": "event", "name": "cohort.refill", "ts": ..., "slot": 2, ...}

Tracing never touches program math, RNG streams, or cache keys.
"""

from __future__ import annotations

import collections
import contextlib
import json
import time
from typing import Any, Deque, Dict, Iterator, List, Optional

import torch

#: in-memory event buffer bound of the default tracer — big enough for
#: a whole fleet drain, small enough to never matter.
DEFAULT_BUFFER = 4096


def _jsonable(v: Any) -> Any:
    """Coerce numpy/torch scalars (and anything else) to JSON-safe
    values; arrays become lists, unknown objects become ``repr``."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if hasattr(v, "item") and getattr(v, "ndim", None) == 0:
        return v.item()
    if hasattr(v, "tolist"):
        return v.tolist()
    return repr(v)


@contextlib.contextmanager
def _annotate(name: str) -> Iterator[None]:
    """``record_function(name)``, plus an NVTX range when CUDA is up
    (pushing one would initialise CUDA, and a CPU build has no NVTX)."""
    nvtx = torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


class Tracer:
    """Collects span/event records; optionally streams them as JSONL.

    One process-wide instance (:func:`get_tracer`) backs the module
    level :func:`span` / :func:`event` helpers; tests and embedders can
    build private tracers and swap them in with :func:`configure` /
    :func:`use_tracer`.
    """

    def __init__(self, jsonl_path: Optional[str] = None,
                 buffer: int = DEFAULT_BUFFER):
        self._events: Deque[Dict[str, Any]] = collections.deque(
            maxlen=buffer)
        self._path = jsonl_path
        self._file = open(jsonl_path, "a") if jsonl_path else None

    # -- recording -----------------------------------------------------------

    def emit(self, record: Dict[str, Any]) -> None:
        self._events.append(record)
        if self._file is not None:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()

    def event(self, name: str, **attrs: Any) -> None:
        """Record an instantaneous event."""
        self.emit({"ev": "event", "name": name, "ts": time.time(),
                   **{k: _jsonable(v) for k, v in attrs.items()}})

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[Dict[str, Any]]:
        """Timed scope: host wall duration + ``record_function`` / NVTX.

        Yields a mutable dict — attributes added to it inside the block
        land on the emitted record (e.g. a wave span learns how many
        slots finished only after stepping)."""
        extra: Dict[str, Any] = {}
        t0 = time.perf_counter_ns()
        with _annotate(name):
            try:
                yield extra
            finally:
                dur_ns = time.perf_counter_ns() - t0
                self.emit({"ev": "span", "name": name, "ts": time.time(),
                           "dur_us": dur_ns / 1e3,
                           **{k: _jsonable(v) for k, v in attrs.items()},
                           **{k: _jsonable(v) for k, v in extra.items()}})

    # -- introspection / lifecycle -------------------------------------------

    def events(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        """A snapshot of the buffered events (newest last), optionally
        filtered by ``name``."""
        evs = list(self._events)
        if name is not None:
            evs = [e for e in evs if e.get("name") == name]
        return evs

    def clear(self) -> None:
        self._events.clear()

    @property
    def jsonl_path(self) -> Optional[str]:
        return self._path

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-wide tracer behind :func:`span` / :func:`event`."""
    return _TRACER


def use_tracer(tracer: Tracer) -> Tracer:
    """Swap the process-wide tracer (returns the previous one)."""
    global _TRACER
    prev, _TRACER = _TRACER, tracer
    return prev


def configure(jsonl_path: Optional[str] = None,
              buffer: int = DEFAULT_BUFFER) -> Tracer:
    """Replace the process-wide tracer — with a JSONL sink, the way the
    launchers' ``--metrics-out`` wires span streaming on."""
    old = use_tracer(Tracer(jsonl_path=jsonl_path, buffer=buffer))
    old.close()
    return get_tracer()


def span(name: str, **attrs: Any):
    """``with trace.span("session.dispatch", mode="sync"): ...``"""
    return _TRACER.span(name, **attrs)


def event(name: str, **attrs: Any) -> None:
    """Record an instantaneous event on the process-wide tracer."""
    _TRACER.event(name, **attrs)


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Parse a span/event JSONL file (skipping blank lines)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out

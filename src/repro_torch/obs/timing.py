"""Wall-clock timing helpers — one implementation for every bench.

A copy of the reference's ``repro.obs.timing`` (pure Python).  All
primitives measure host wall-clock via ``time.perf_counter_ns`` and
report floats; a device time needs CUDA events around the work (a host
clock without a synchronise measures the enqueue).

  * :func:`time_block` — ``with time_block() as tb: ...`` then read
    ``tb.ns`` / ``tb.us`` / ``tb.ms`` / ``tb.s``;
  * :func:`timeit_us` — mean µs/call over ``n`` calls after ``warmup``
    (the microbench contract);
  * :func:`repeat_s` — per-repeat wall seconds of a callable (the
    min-of-repeats benches take ``min()`` themselves — the floor is the
    honest cost on a shared CPU host);
  * :func:`summarize_ns` — min/mean/percentile summary of raw samples.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Iterator, List, Sequence


class TimedBlock:
    """The result handle :func:`time_block` yields; durations are
    populated when the ``with`` block exits (0 until then)."""

    __slots__ = ("ns",)

    def __init__(self) -> None:
        self.ns: int = 0

    @property
    def us(self) -> float:
        return self.ns / 1e3

    @property
    def ms(self) -> float:
        return self.ns / 1e6

    @property
    def s(self) -> float:
        return self.ns / 1e9


@contextlib.contextmanager
def time_block() -> Iterator[TimedBlock]:
    """Time a ``with`` block: ``with time_block() as tb: ...; tb.us``."""
    tb = TimedBlock()
    t0 = time.perf_counter_ns()
    try:
        yield tb
    finally:
        tb.ns = time.perf_counter_ns() - t0


def timeit_us(fn: Callable[[], object], n: int = 50,
              warmup: int = 3) -> float:
    """Mean µs per call of ``fn`` over ``n`` calls (after ``warmup``
    unrecorded calls) — the microbench ``_time`` contract."""
    for _ in range(warmup):
        fn()
    with time_block() as tb:
        for _ in range(n):
            fn()
    return tb.us / n


def repeat_s(fn: Callable[[], object], repeats: int) -> List[float]:
    """Wall seconds of each of ``repeats`` calls of ``fn`` (no warmup —
    the benches warm explicitly so compile cost is visible where they
    choose, not here)."""
    out: List[float] = []
    for _ in range(repeats):
        with time_block() as tb:
            fn()
        out.append(tb.s)
    return out


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile of an ascending sequence."""
    if len(sorted_vals) == 1:
        return float(sorted_vals[0])
    pos = q / 100.0 * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return float(sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac)


def summarize_ns(samples_ns: Sequence[float]) -> Dict[str, float]:
    """Summary statistics of raw duration samples (any unit — the name
    records the convention the span layer emits): min/mean/std/p50/p90/
    max plus the sample count.  ``std`` is the population standard
    deviation (0 for a single sample) — the BENCH rows' spread
    convention."""
    if not samples_ns:
        return {"count": 0, "min": 0.0, "mean": 0.0, "std": 0.0,
                "p50": 0.0, "p90": 0.0, "max": 0.0}
    vals = sorted(float(x) for x in samples_ns)
    mean = sum(vals) / len(vals)
    var = sum((x - mean) ** 2 for x in vals) / len(vals)
    return {
        "count": len(vals),
        "min": vals[0],
        "mean": mean,
        "std": var ** 0.5,
        "p50": _percentile(vals, 50.0),
        "p90": _percentile(vals, 90.0),
        "max": vals[-1],
    }

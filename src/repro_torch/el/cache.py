"""Bounded program cache, shared by a session's compiled runs.

A copy of the reference's ``ProgramCache`` (pure Python), less its
program-profile store (observability, a later slice).  Here an entry
is a compiled program (``repro_torch.el.ingraph.SyncProgram`` or
``repro_torch.el.events.AsyncProgram``): its static device buffers (the
padded per-edge datasets, the carry, the knob and draw buffers) and, on
a card, the CUDA graph captured over them.
Each entry pins those buffers, so the cache is a bounded FIFO, and
``clear()`` is what releases them on a long-lived session.  The
reference's cache events on its tracer come with the observability slice.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional


class ProgramCache:
    """Insertion-ordered dict of compiled programs with FIFO eviction.

    ``len`` / ``in`` / iteration / ``values()`` behave like a plain
    dict.  ``hits`` / ``misses`` / ``evictions`` count ``get()`` /
    ``put()`` outcomes and are surfaced as a snapshot by :meth:`stats`
    (``ELReport.telemetry["cache"]``).
    """

    def __init__(self, max_entries: int = 8):
        self.max_entries = int(max_entries)
        self._entries: Dict[tuple, Any] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: tuple, default: Optional[Any] = None) -> Any:
        entry = self._entries.get(key, default)
        if entry is default:
            self.misses += 1
        else:
            self.hits += 1
        return entry

    def put(self, key: tuple, program: Any) -> Any:
        """Insert, evicting oldest entries past ``max_entries`` (any
        alias the caller keeps — e.g. the session's last-used fast-path
        handle — keeps an evicted program alive until replaced)."""
        self._entries[key] = program
        while len(self._entries) > self.max_entries:
            evicted = next(iter(self._entries))
            self._entries.pop(evicted)
            self.evictions += 1
        return program

    def stats(self) -> Dict[str, int]:
        """Counter snapshot: entries/max_entries/hits/misses/evictions."""
        return {
            "entries": len(self._entries),
            "max_entries": self.max_entries,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
        }

    def clear(self) -> int:
        """Drop every cached program, returning how many were dropped.
        Their device buffers (and captured graphs) become collectible once
        callers also drop their aliases."""
        n = len(self._entries)
        self._entries.clear()
        return n

    # -- dict-compatible surface ---------------------------------------------

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: tuple) -> bool:
        return key in self._entries

    def __iter__(self) -> Iterator[tuple]:
        return iter(self._entries)

    def values(self):
        return self._entries.values()

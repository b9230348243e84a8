"""Bounded program cache, shared by sessions and fleet cohorts.

A copy of the reference's ``ProgramCache`` (pure Python), with its
program-profile side-store: ``set_profile`` / ``profile`` / ``profiles``
keep one ``repro_torch.obs.prof.ProgramProfile`` per cached program,
counted in ``stats()["profiled"]`` and dropped with the entry on
eviction and ``clear()``.  Here an entry is a compiled program
(``repro_torch.el.ingraph.SyncProgram``,
``repro_torch.el.events.AsyncProgram``, a sweep's runner or a fleet
cohort's ``CellBatch``): its static device buffers (the
padded per-edge datasets, the carry, the knob and draw buffers) and, on
a card, the CUDA graph captured over them.  Each entry pins those
buffers, so the cache is a bounded FIFO, and ``clear()`` is what
releases them on a long-lived session or server.  A
``repro_torch.el.fleet.FleetServer`` can share a session's cache (and
its hit/miss counters — the fleet's compiles-per-cohort check).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional


class ProgramCache:
    """Insertion-ordered dict of compiled programs with FIFO eviction.

    ``len`` / ``in`` / iteration / ``values()`` behave like a plain
    dict.  ``hits`` / ``misses`` / ``evictions`` count ``get()`` /
    ``put()`` outcomes and are surfaced as a snapshot by :meth:`stats`
    (``ELReport.telemetry["cache"]``, the fleet CLI's summary line).
    Lookups and evictions also emit ``cache.hit`` / ``cache.miss`` /
    ``cache.evict`` events on the process tracer
    (``repro_torch.obs.trace``), so a JSONL span stream shows exactly
    when a server rebuilt a program.
    """

    def __init__(self, max_entries: int = 8):
        self.max_entries = int(max_entries)
        self._entries: Dict[tuple, Any] = {}
        # per-entry ProgramProfile side-store (repro_torch.obs.prof): kept
        # out of _entries so cached values stay the programs themselves;
        # evicted with the entry
        self._profiles: Dict[tuple, Any] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: tuple, default: Optional[Any] = None) -> Any:
        from repro_torch.obs import trace
        entry = self._entries.get(key, default)
        if entry is default:
            self.misses += 1
            trace.event("cache.miss", misses=self.misses)
        else:
            self.hits += 1
            trace.event("cache.hit", hits=self.hits)
        return entry

    def put(self, key: tuple, program: Any) -> Any:
        """Insert, evicting oldest entries past ``max_entries`` (any
        alias the caller keeps — e.g. the session's last-used fast-path
        handle — keeps an evicted program alive until replaced)."""
        from repro_torch.obs import trace
        self._entries[key] = program
        while len(self._entries) > self.max_entries:
            evicted = next(iter(self._entries))
            self._entries.pop(evicted)
            self._profiles.pop(evicted, None)
            self.evictions += 1
            trace.event("cache.evict", evictions=self.evictions)
        return program

    def set_profile(self, key: tuple, profile: Any) -> Any:
        """Attach a :class:`repro_torch.obs.prof.ProgramProfile` to a
        cached program (no-op for unknown keys: the entry may have been
        evicted between build and profile)."""
        if key in self._entries:
            self._profiles[key] = profile
        return profile

    def profile(self, key: tuple) -> Optional[Any]:
        """The profile attached to a cached program (None when never
        profiled, or evicted)."""
        return self._profiles.get(key)

    def profiles(self) -> Dict[tuple, Any]:
        """Snapshot of every attached profile (key → ProgramProfile)."""
        return dict(self._profiles)

    def stats(self) -> Dict[str, int]:
        """Counter snapshot: entries/max_entries/hits/misses/evictions
        (+ how many entries carry a profile)."""
        return {
            "entries": len(self._entries),
            "max_entries": self.max_entries,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "profiled": len(self._profiles),
        }

    def clear(self) -> int:
        """Drop every cached program, returning how many were dropped.
        Their device buffers (and captured graphs) become collectible once
        callers also drop their aliases."""
        n = len(self._entries)
        self._entries.clear()
        self._profiles.clear()
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

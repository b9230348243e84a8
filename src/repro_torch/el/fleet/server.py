"""The fleet server: multi-tenant EL-as-a-service over cohort batches.

:class:`FleetServer` accepts :class:`TenantRun` submissions, buckets
them into cohorts keyed on the STRUCTURAL config (mode, data plane,
metric, horizon — everything that shapes the compiled program; knob
values and seeds are inputs), and drives every cohort in slot waves: a
fixed ``[n_slots]`` batch stepped ``rounds_per_wave`` iterations at a
time with an activity mask (one CUDA graph replay a wave on a card),
finished slots refilled from the admission queue mid-flight (continuous
batching).  Per-tenant progress streams to subscribers as
:class:`RoundDelta` / :class:`ReportReady` events as waves complete.

Every tenant's trajectory is bit-identical to an independent
``ELSession.run_sync_ingraph`` / ``run_async_ingraph`` of that
submission alone on the same draws — the cohort program is the very
same cell the single-run programs drive, vmapped over the slots, and
inactive slots run zero iterations (see ``make_cell_batch``).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.el.cache import ProgramCache
from repro_torch.el.executor import validate_executor
from repro_torch.el.fleet.cohort import Cohort
from repro_torch.el.fleet.tenant import TenantRun
from repro_torch.el.report import ELReport
from repro_torch.el.session import DEFAULT_SYNC_HORIZON, _MESH_ITEM


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


class FleetServer:
    """Slot-batched cohort server over the compiled EL programs.

    ``n_slots`` fixes each cohort's batch width (tenants beyond it
    queue and admit as slots free up); ``rounds_per_wave`` is the
    device-side iteration chunk between host harvest points — larger
    waves amortize dispatch, smaller waves tighten streaming latency.
    ``device`` is where the cohorts run (default CUDA, raising without
    it; pass ``"cpu"`` for the CPU); every tenant's executor must live
    there.  ``cache`` lets the server share an ``ELSession.
    compile_cache`` so cohort programs and the session's verification
    runs pool one bounded cache (and one hit/miss counter); by default
    the server owns a private one.  A cohort's program keeps its
    tenants' state in its static buffers, so two live servers sharing a
    cache serve one structure in turn, not at once.

    ``telemetry=`` gates the device rings (``repro_torch.obs.rings``) of
    every cohort program (off, the default, builds the ungated programs).
    Each tenant's report then carries its own ring snapshot in
    ``report.telemetry["rings"]``.  The gate joins the cohort key, so on
    and off tenants never share a cohort.

    ``profile=`` (or ``REPRO_EL_PROFILE=1``) profiles each cohort's wave
    program once, at its first wave (``repro_torch.obs.prof``; the
    stacked carry is updated in place, so the profile is ``donated``),
    and every tenant report from that cohort carries it as
    ``report.telemetry["profile"]``.

    ``mesh=`` (ROADMAP Queue 1 item 14) raises ``NotImplementedError``.
    """

    def __init__(self, *, n_slots: int = 4, rounds_per_wave: int = 32,
                 mesh=None, cache: Optional[ProgramCache] = None,
                 max_cached: int = 8, telemetry=None,
                 profile: bool = False, device: DeviceLike = None):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if mesh is not None:
            raise NotImplementedError(
                "FleetServer(mesh=...): sharded cohorts arrive with "
                f"{_MESH_ITEM}")
        from repro_torch.obs.rings import as_spec
        self.device = resolve_device(device)
        self.telemetry = as_spec(telemetry)
        self.profile = bool(profile or os.environ.get("REPRO_EL_PROFILE"))
        self.n_slots = int(n_slots)
        self.rounds_per_wave = int(rounds_per_wave)
        self._owns_cache = cache is None
        self._cache = ProgramCache(max_cached) if cache is None else cache
        self._cohorts: Dict[tuple, Cohort] = {}
        self._subscribers: List[Callable[[Any], None]] = []
        self._reports: Dict[str, ELReport] = {}
        self._submitted = 0
        self.compiles = 0                # cohort programs actually built
        self._closed = False

    # -- subscription --------------------------------------------------------

    def subscribe(self, callback: Callable[[Any], None]) -> "FleetServer":
        """Register a subscriber; called with every :class:`RoundDelta`
        and :class:`ReportReady` as waves complete."""
        self._subscribers.append(callback)
        return self

    def _emit(self, event: Any) -> None:
        for cb in self._subscribers:
            cb(event)

    # -- admission -----------------------------------------------------------

    def _cohort_key(self, run: TenantRun, horizon: int) -> tuple:
        from repro_torch.el.session import ELSession
        n_samples = (None if run.cfg.mode == "async"
                     or run.n_samples is None
                     else tuple(float(x) for x in run.n_samples))
        return ("fleet", run.executor,
                ELSession._structural_cfg(run.cfg), run.metric_fn,
                run.metric_name, n_samples, horizon, self.n_slots,
                self.rounds_per_wave, self.telemetry)

    def _horizon(self, run: TenantRun) -> int:
        if run.cfg.mode == "async":
            # padded (power-of-two) so nearby budget/cost points bucket
            # into ONE cohort program — the run_async_ingraph default
            from repro_torch.el.events.knobs import padded_event_horizon
            return padded_event_horizon(run.cfg)
        return int(run.max_rounds or DEFAULT_SYNC_HORIZON)

    def submit(self, run: TenantRun) -> str:
        """Admit a tenant: validate, bucket into its cohort (building
        and caching the cohort's slot-batch program on first sight of
        the structure), queue for the next free slot.  Returns the
        tenant id events will carry."""
        if self._closed:
            raise RuntimeError("FleetServer is closed")
        from repro_torch.el.ingraph import check_ingraph_support
        validate_executor(run.executor)
        check_ingraph_support(run.cfg, run.executor,
                              caller="FleetServer.submit")
        ex_dev = getattr(run.executor, "device", None)
        if ex_dev is not None and not _same_device(torch.device(ex_dev),
                                                   self.device):
            raise ValueError(
                f"FleetServer.submit: the tenant's executor lives on "
                f"{ex_dev}, the server's cohorts on {self.device}")
        tenant_id = run.tenant_id or f"tenant-{self._submitted:04d}"
        if tenant_id in self._reports or any(
                tenant_id == a.tenant_id
                for c in self._cohorts.values()
                for a in c._slots if a is not None) or any(
                tenant_id == p[2]
                for c in self._cohorts.values() for p in c._pending):
            raise ValueError(f"duplicate tenant_id {tenant_id!r}")
        self._submitted += 1
        horizon = self._horizon(run)
        key = self._cohort_key(run, horizon)
        cohort = self._cohorts.get(key)
        if cohort is None:
            cohort = Cohort(key, self._batch_for(run, horizon),
                            self._knobs_fn(run), profile=self.profile,
                            cache=self._cache)
            self._cohorts[key] = cohort
        cohort.submit(tenant_id, run)
        return tenant_id

    @staticmethod
    def _knobs_fn(run: TenantRun) -> Callable:
        if run.cfg.mode == "async":
            from repro_torch.el.events.knobs import async_knobs
            return async_knobs
        from repro_torch.el.ingraph import sync_knobs
        return sync_knobs

    @staticmethod
    def _n_samples_of(run: TenantRun) -> Optional[np.ndarray]:
        # async single runs ignore n_samples (run_async_ingraph takes
        # none) — mirror that so fleet == independent run, bit for bit
        if run.cfg.mode == "async" or run.n_samples is None:
            return None
        return np.asarray(run.n_samples, np.float64)

    def _batch_for(self, run: TenantRun, horizon: int):
        """The cohort's slot-batch engine, via the shared program cache —
        one build (and, on a card, one graph capture) per structure."""
        from repro_torch.el.sweep.engine import make_cell_batch
        from repro_torch.obs import trace
        key = self._cohort_key(run, horizon)
        batch = self._cache.get(key)
        if batch is None:
            ex = run.executor
            with trace.span("fleet.compile", mode=run.cfg.mode,
                            n_slots=self.n_slots,
                            telemetry=self.telemetry is not None):
                batch = make_cell_batch(
                    ex.model, ex.edge_data, ex.eval_set, run.cfg,
                    n_slots=self.n_slots,
                    rounds_per_wave=self.rounds_per_wave,
                    lr=ex.lr, batch=ex.batch,
                    n_samples=self._n_samples_of(run),
                    metric_fn=run.metric_fn, metric_name=run.metric_name,
                    horizon=horizon, telemetry=self.telemetry,
                    device=self.device)
                self._cache.put(key, batch)
                self.compiles += 1
        return batch

    # -- the service loop ----------------------------------------------------

    def step(self) -> Dict[str, ELReport]:
        """One wave across every cohort with work.  Streams events and
        returns the reports completed by this step (also retrievable
        later via :meth:`report`)."""
        if self._closed:
            raise RuntimeError("FleetServer is closed")
        done: Dict[str, ELReport] = {}
        for cohort in self._cohorts.values():
            if cohort.has_work:
                for tenant_id, report in cohort.wave(self._emit):
                    done[tenant_id] = report
        self._reports.update(done)
        return done

    def drain(self) -> Dict[str, ELReport]:
        """Step until every admitted tenant has completed; returns ALL
        reports the server has delivered (tenant_id → report)."""
        while any(c.has_work for c in self._cohorts.values()):
            self.step()
        return dict(self._reports)

    def report(self, tenant_id: str) -> Optional[ELReport]:
        return self._reports.get(tenant_id)

    # -- introspection / lifecycle -------------------------------------------

    def cohorts(self) -> List[Cohort]:
        """The live cohorts, in order of first submission."""
        return list(self._cohorts.values())

    def stats(self) -> Dict[str, Any]:
        return {
            "tenants_submitted": self._submitted,
            "tenants_done": len(self._reports),
            "tenants_pending": sum(c.n_pending
                                   for c in self._cohorts.values()),
            "tenants_active": sum(c.n_active
                                  for c in self._cohorts.values()),
            "cohorts": len(self._cohorts),
            "compiles": self.compiles,
            "cache_hits": self._cache.hits,
            "cache_misses": self._cache.misses,
            "cache_evictions": self._cache.evictions,
            "waves": sum(c.waves for c in self._cohorts.values()),
            # wave-batched data-plane dispatches: one place_many scatter
            # per admitting wave, one take_many gather per finalizing
            # wave — never per tenant
            "place_dispatches": sum(c.place_dispatches
                                    for c in self._cohorts.values()),
            "gather_dispatches": sum(c.gather_dispatches
                                     for c in self._cohorts.values()),
        }

    def close(self) -> None:
        """Release every cohort's carry and (when the server owns its
        cache) the compiled programs, their device buffers and captured
        graphs — after this the server refuses submissions.  Delivered
        reports stay readable.  Idempotent."""
        for cohort in self._cohorts.values():
            cohort.release()
        self._cohorts = {}
        if self._owns_cache:
            self._cache.clear()
        self._closed = True

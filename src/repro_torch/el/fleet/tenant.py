"""Tenant-facing records of the fleet server: what a caller submits
(:class:`TenantRun`) and the two event types streamed back to
subscribers (:class:`RoundDelta` per completed aggregation,
:class:`ReportReady` when the tenant's run finishes)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

from repro_torch.config import OL4ELConfig
from repro_torch.el.report import ELReport, RoundRecord


@dataclasses.dataclass(frozen=True)
class TenantRun:
    """One tenant's EL run, as submitted to :class:`FleetServer.submit`.

    ``cfg`` carries both the structure (mode, n_edges, utility — the
    cohort key) and the knob point (budget, ucb_c, seed, ... — inputs
    of the cohort's one compiled program).  ``executor`` is the
    tenant's in-graph data plane (e.g. ``ClassicExecutor``); tenants
    sharing an executor + structural config share a cohort and its
    compiled slot-batch program.

    ``init_params=None`` resolves to ``executor.init_params(cfg.seed)``
    at admission — the same default an ``ELSession`` uses.  ``draws`` is
    the tenant's RNG-seam provider (``repro_torch.el.rng``): ``None``
    resolves at admission to a ``TorchDraws`` over a ``torch.Generator``
    on the cohort's device seeded with ``cfg.seed + 17``, exactly what
    ``run_sync_ingraph`` / ``run_async_ingraph`` draw from, which is
    what keeps a fleet tenant bit-identical to an independent run of the
    same submission; a ``ReplayDraws`` of the reference's ``jax.random``
    stream makes the reference's decisions.  A provider is consumed as
    the tenant runs, so submit a fresh one per run.  ``n_samples``
    (per-edge aggregation weights) applies to sync runs only, mirroring
    the session fast paths.  Higher ``priority`` admits first; ties
    admit in submission order.
    """

    cfg: OL4ELConfig
    executor: Any
    tenant_id: Optional[str] = None
    priority: int = 0
    metric_fn: Optional[Callable] = None
    metric_name: str = "accuracy"
    n_samples: Optional[Sequence[float]] = None
    init_params: Any = None
    #: sync history length (compiled ``max_rounds``); ``None`` → 512.
    #: Async cohorts size their history from the padded event horizon.
    max_rounds: Optional[int] = None
    draws: Any = None


@dataclasses.dataclass(frozen=True)
class RoundDelta:
    """Streamed to subscribers after each wave, once per aggregation the
    tenant completed in that wave — read straight from the live device
    history, so the deltas a subscriber accumulates are the finished
    report's ``records`` (same arrays, read incrementally)."""

    tenant_id: str
    record: RoundRecord


@dataclasses.dataclass(frozen=True)
class ReportReady:
    """Streamed when a tenant's run terminates and its slot is freed."""

    tenant_id: str
    report: ELReport

"""``repro_torch.el.fleet`` — multi-tenant EL-as-a-service.

A persistent, host-driven service over the compiled EL programs:

  * :class:`TenantRun` — one tenant's submission (config + executor +
    seed + knob point + priority + draw provider);
  * :class:`FleetServer` — buckets tenants into cohorts (one
    knob-parameterized slot-batch program per structural config),
    drives each cohort in fixed-width slot waves with mid-flight refill
    (continuous batching), one CUDA graph replay a wave on a card;
  * :class:`RoundDelta` / :class:`ReportReady` — per-tenant events
    streamed to subscribers as rounds complete;
  * :class:`Cohort` — the per-structure slot/admission state machine,
    over the port's :class:`repro_torch.el.sweep.CellBatch`.

Correctness bar: every tenant's streamed report is bit-identical to an
independent ``ELSession.run_sync_ingraph`` / ``run_async_ingraph`` of
that tenant alone on the same draws, and on the reference's replayed
``jax.random`` draws makes the reference's solo run's decisions (see
``tests/test_torch_fleet.py``).

CLI front door: ``python -m repro_torch.launch.fleet``.
"""

from repro_torch.el.fleet.cohort import Cohort
from repro_torch.el.fleet.server import DEFAULT_SYNC_HORIZON, FleetServer
from repro_torch.el.fleet.tenant import ReportReady, RoundDelta, TenantRun

__all__ = [
    "FleetServer", "TenantRun", "RoundDelta", "ReportReady", "Cohort",
    "DEFAULT_SYNC_HORIZON",
]

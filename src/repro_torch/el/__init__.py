"""``repro_torch.el`` — the edge-cloud collaborative-learning runtime.

  * :class:`ELSession` — configure-then-run façade (host sync/async loops);
  * :class:`ELReport` / :class:`RoundRecord` — run artifacts;
  * :mod:`repro_torch.el.policies` — collaboration strategies behind a
    registry (``policies.get("ol4el")``);
  * :class:`EdgeExecutor` — the typed data-plane Protocol executors
    implement (``ClassicExecutor`` satisfies it);
  * :mod:`repro_torch.el.fleet` — multi-tenant EL-as-a-service:
    :class:`FleetServer` buckets :class:`TenantRun` submissions into
    slot-batched cohorts and streams :class:`RoundDelta` /
    :class:`ReportReady` events.
"""

from repro_torch.el import policies
from repro_torch.el.executor import (EdgeExecutor, InGraphExecutor,
                                     validate_executor)
from repro_torch.el.report import ELReport, RoundRecord
from repro_torch.el.session import ELSession
from repro_torch.el.fleet import (FleetServer, ReportReady, RoundDelta,
                                  TenantRun)

__all__ = ["ELSession", "ELReport", "RoundRecord", "EdgeExecutor",
           "InGraphExecutor", "validate_executor", "policies",
           "FleetServer", "TenantRun", "RoundDelta", "ReportReady"]

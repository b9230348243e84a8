"""DEPRECATED shim — the event-driven EL simulator is now ``ELSession``.

The host-driven sync/async loops (the paper's §V testbed analogue) live in
:mod:`repro_torch.el.session`; this module keeps the reference's
historical ``ELSimulator`` constructor signature and result types
importable so old call sites keep working::

    from repro_torch.federated import ELSimulator, SimResult

    sim = ELSimulator(executor, cfg, init_params, ...)
    result = sim.run()        # delegates to ELSession.run()

New code should use::

    from repro_torch.el import ELSession
    report = ELSession(cfg).with_executor(executor, ...).run()

The session draws a variable-cost block's cost once and uses it for both
its finish time and its charge (the historical simulator drew twice).
"""

from __future__ import annotations

import warnings
from typing import Any, Optional

import numpy as np

from repro_torch.config import OL4ELConfig
from repro_torch.el.report import ELReport, RoundRecord

Params = Any

# Legacy names: SimResult was the pre-ELReport result dataclass with the
# same fields; RoundRecord moved unchanged.
SimResult = ELReport

__all__ = ["ELSimulator", "SimResult", "RoundRecord"]


class ELSimulator:
    """Deprecated adapter over :class:`repro_torch.el.ELSession`."""

    def __init__(self, executor, cfg: OL4ELConfig,
                 init_params: Params,
                 n_samples: Optional[np.ndarray] = None,
                 metric_name: str = "accuracy",
                 lr: float = 0.1,
                 async_alpha: Optional[float] = None):
        warnings.warn(
            "ELSimulator is deprecated; use repro_torch.el.ELSession",
            DeprecationWarning, stacklevel=2)
        from repro_torch.el.session import ELSession
        self.cfg = cfg
        self.ex = executor
        self.session = ELSession(
            cfg, metric_name=metric_name, lr=lr, async_alpha=async_alpha
        ).with_executor(executor, init_params=init_params,
                        n_samples=n_samples)

    @property
    def coord(self):
        # eager like the old simulator: the coordinator (budgets, costs,
        # bandits) is inspectable/adjustable before run(), and the next
        # run consumes exactly this instance
        return self.session.coordinator()

    def run_sync(self, max_rounds: int = 10_000,
                 eval_every: int = 1) -> SimResult:
        return self.session.run_sync(max_rounds=max_rounds,
                                     eval_every=eval_every)

    def run_async(self, max_events: Optional[int] = None,
                  eval_every: int = 1) -> SimResult:
        # None derives the event horizon from budget/cost (no silent
        # truncation), matching ELSession.run_async
        return self.session.run_async(max_events=max_events,
                                      eval_every=eval_every)

    def run(self, **kw) -> SimResult:
        return self.session.run(**kw)

"""Event-horizon arithmetic of the async loop (numpy).

Only ``default_event_horizon`` is needed by the host ``run_async``; the
traced knobs of the compiled async engine come with that slice.
"""

from __future__ import annotations

import numpy as np

from repro_torch.config import OL4ELConfig
from repro_torch.core.coordinator import edge_speed_factors


def default_event_horizon(cfg: OL4ELConfig) -> int:
    """An event horizon guaranteed to exceed any run's event count.

    Every completed block charges its edge at least ``comp_e + comm_e``
    (times the 0.1 multiplier floor in variable-cost mode), and an
    edge only schedules while its residual covers that minimum — so
    per-edge completions are bounded by ``budget / min_cost`` plus the
    one block in flight at the first infeasibility.  Unlike a fixed
    ``max_events`` cap this scales with budget/cost, so long runs are
    never silently truncated.
    """
    speed = edge_speed_factors(cfg.n_edges, cfg.heterogeneity)
    min_cost = cfg.comp_cost * speed + cfg.comm_cost                # [E]
    floor = 0.1 if (cfg.cost_model == "variable"
                    and cfg.cost_noise > 0) else 1.0
    per_edge = np.floor(cfg.budget / (floor * min_cost)) + 1.0
    return int(per_edge.sum())

"""Control-plane inputs and event horizons of the async event engine
(numpy, host side).

Mirrors ``repro_torch.el.ingraph.sync_knobs``: everything a run's values
can change (exploration constant, budgets, cost arrays, cost-noise
scale, staleness-mix base rate, the exact event cap) enters the compiled
async program as an input, so one program (and one captured graph)
serves any knob point.  The async program keeps one bandit per edge, so
its arm costs are the full per-edge matrix ``costs_ek`` ``[E, K]``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.config import OL4ELConfig
from repro_torch.core.coordinator import edge_speed_factors
from repro_torch.el.ingraph import base_cost_knobs

#: Inputs of the compiled async program: scalars ``ucb_c`` / ``budget`` /
#: ``cost_noise`` / ``async_alpha``, the int32 ``event_cap`` (the run's
#: exact event budget; the history length is a power of two above it),
#: per-edge ``comp`` / ``comm`` / ``min_edge_cost`` ``[E]``, and the
#: per-edge arm costs ``costs_ek`` ``[E, K]``.
ASYNC_KNOB_NAMES = ("ucb_c", "budget", "comp", "comm", "costs_ek",
                    "min_edge_cost", "cost_noise", "async_alpha",
                    "event_cap")


def async_knobs(cfg: OL4ELConfig) -> Dict[str, np.ndarray]:
    """Host-side inputs of the compiled async program, in the reference's
    f32 numpy arithmetic (shared with the sync path through
    ``base_cost_knobs``), plus the scenario knobs (no ``policy_id``: the
    async engine keeps the per-edge OL4EL bandit) when ``cfg.scenario``
    is set."""
    knobs = base_cost_knobs(cfg)
    intervals_f = np.arange(1, cfg.max_interval + 1, dtype=np.float32)
    # async bandits are per-edge: every edge scores its own arm costs
    knobs["costs_ek"] = (intervals_f[None, :] * knobs["comp"][:, None]
                         + knobs["comm"][:, None])                  # [E, K]
    knobs["async_alpha"] = np.float32(cfg.async_alpha)
    knobs["event_cap"] = np.int32(default_event_horizon(cfg))
    if cfg.scenario is not None:
        from repro_torch.el.scenarios.schedule import scenario_knobs
        knobs.update(scenario_knobs(cfg))
    return knobs


def async_knob_names(cfg: OL4ELConfig) -> Tuple[str, ...]:
    """The input names of this config's compiled async program:
    ``ASYNC_KNOB_NAMES``, plus the scenario schedule knobs when
    ``cfg.scenario`` is set (exactly the keys ``async_knobs(cfg)``
    returns)."""
    if cfg.scenario is not None:
        from repro_torch.el.scenarios.schedule import scenario_knob_names
        return ASYNC_KNOB_NAMES + scenario_knob_names("async")
    return ASYNC_KNOB_NAMES


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


def padded_event_horizon(cfg: OL4ELConfig) -> int:
    """:func:`default_event_horizon` rounded up to a power of two (floor
    64).  The horizon sizes the program's history, so it is part of the
    program-cache key; rounding keeps nearby budget and cost points on
    one program."""
    return max(64, 1 << (default_event_horizon(cfg) - 1).bit_length())


def bucket_event_horizon(cap: int) -> int:
    """An explicit event cap's history length: the next power of two
    (floor 64).  The exact cap rides in as the ``event_cap`` knob, so
    nearby caps share one program."""
    return max(64, 1 << (max(int(cap), 1) - 1).bit_length())


def resolve_async_batch_k(cfg: OL4ELConfig) -> int:
    """The engine's K-event wave width.  ``cfg.async_batch_k > 0`` pins it,
    clamped to ``n_edges`` (a wave pops distinct edges); ``0`` resolves
    to 1, as the reference resolves it without a mesh (sharded runs are
    ROADMAP Queue 1 item 14) and under a scenario (whose body is the
    single-event one; ``make_async_cell`` refuses a pinned K > 1 with a
    scenario)."""
    if cfg.async_batch_k > 0:
        return max(1, min(int(cfg.async_batch_k), cfg.n_edges))
    return 1

"""Host-side replay oracle for the device scenario engine.

A copy of the reference's ``repro.el.scenarios.reference``, pointed at
the port's ``sync_knobs``: it checks the port's own outputs.

The scenario sync round (``make_sync_cell`` with ``cfg.scenario`` set)
gathers its churn/straggler schedules from the ``scn_active`` /
``scn_mult`` knob arrays and does all masking, charging and pacing on
the device.  This module re-derives the same run in plain numpy — mask
per round, slowest-ACTIVE-edge slot, per-edge charging, loop termination
— from nothing but the config and the device run's per-round
``interval`` decisions, and checks the device history EVENT-FOR-EVENT
against it.

That is the correctness bar the scenario engine is held to: the masked
tensor arithmetic (``torch.where`` chains inside chunks of masked rounds)
must agree with the obvious sequential bookkeeping a human would write
down.  Arm choices themselves are not re-derived (they come from the
draws); everything *downstream* of each choice is.

Restricted to ``cost_noise == 0`` runs: with the i.i.d. cost noise off
the multiplier is exactly 1.0, every per-round float32 op here mirrors
the device's elementwise op, and the replay matches bit-for-bit, not
just to tolerance.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from repro_torch.config import OL4ELConfig
from repro_torch.el.scenarios.schedule import activity_schedule, cost_schedule
from repro_torch.el.scenarios.spec import ScenarioSpec

__all__ = ["replay_sync_scenario", "verify_sync_replay"]


def _schedules(cfg: OL4ELConfig):
    """The exact [period, E] knob arrays the compiled run gathered from
    (same host-side generators that built them — the replay shares the
    schedule SOURCE and re-derives everything downstream of it)."""
    scn = cfg.scenario
    if not isinstance(scn, ScenarioSpec):
        raise TypeError(
            f"cfg.scenario must be a ScenarioSpec for a scenario replay, "
            f"got {type(scn).__name__}")
    period = scn.period
    active = activity_schedule(scn.churn, cfg.n_edges, period)
    mult = cost_schedule(scn.cost, cfg.n_edges, period)
    return period, active, mult


def replay_sync_scenario(cfg: OL4ELConfig,
                         intervals: np.ndarray,
                         max_rounds: int) -> Dict[str, np.ndarray]:
    """Sequentially replay a sync scenario run from its arm decisions.

    ``intervals`` is the compiled run's per-round ``hist["interval"]``
    (only entries below the replayed round count are read).  Returns the
    replayed per-round histories plus the replay's own termination
    round — everything :func:`verify_sync_replay` compares.
    """
    if cfg.cost_noise != 0:
        raise ValueError(
            "the scenario replay oracle is exact only for cost_noise=0 "
            f"runs (got cost_noise={cfg.cost_noise}); noisy multipliers "
            "come from traced PRNG streams the host does not re-derive")
    from repro_torch.el.ingraph import sync_knobs
    period, sched_act, sched_mult = _schedules(cfg)
    knobs = sync_knobs(cfg)
    comp = knobs["comp"].astype(np.float32)
    comm = knobs["comm"].astype(np.float32)
    costs_k = knobs["costs_k"].astype(np.float32)
    min_edge_cost = knobs["min_edge_cost"].astype(np.float32)
    budget = np.float32(knobs["budget"])

    consumed = np.zeros(cfg.n_edges, np.float32)
    wall = np.float32(0.0)
    hist = {"active_edges": np.zeros(max_rounds, np.int32),
            "consumed": np.zeros(max_rounds, np.float32),
            "wall": np.zeros(max_rounds, np.float32),
            "slot": np.zeros(max_rounds, np.float32)}
    t = 0
    while t < max_rounds:
        act = sched_act[t % period] > 0                          # [E]
        resid = budget - consumed
        # cond_scn verbatim: pace on the tightest ACTIVE edge
        affordable = (np.min(np.where(act, resid, np.inf))
                      >= np.min(costs_k) - 1e-12)
        exhausted = bool(np.any(act & (resid < min_edge_cost)))
        if not (affordable and not exhausted):
            break
        interval = np.int32(intervals[t])
        # body_scn bookkeeping verbatim (float32 elementwise, so the
        # replay is bit-exact against the compiled history)
        round_costs = (np.float32(interval) * comp + comm).astype(
            np.float32)
        round_costs = (round_costs * sched_mult[t % period]).astype(
            np.float32)
        slot = np.float32(np.max(np.where(act, round_costs,
                                          np.float32(0.0))))
        consumed = (consumed + np.where(act, slot,
                                        np.float32(0.0))).astype(
            np.float32)
        wall = np.float32(wall + slot)
        hist["active_edges"][t] = int(np.sum(act))
        hist["consumed"][t] = np.float32(np.sum(consumed))
        hist["wall"][t] = wall
        hist["slot"][t] = slot
        t += 1
    hist["n_rounds"] = np.int32(t)
    hist["budgets_left"] = budget - consumed
    return hist


def verify_sync_replay(cfg: OL4ELConfig, out: Dict[str, Any],
                       max_rounds: int) -> Dict[str, np.ndarray]:
    """Assert a compiled sync scenario run matches its host replay
    event-for-event; returns the replay on success.

    ``out`` is the compiled run's output dict (``report.raw`` /
    ``run_sweep_program`` cell slice): per-round ``interval`` /
    ``active_edges`` / ``consumed`` / ``wall``, plus ``n_rounds`` and
    ``budgets_left``.  Every round's active-edge count must agree
    exactly; budget/wall bookkeeping must agree to float32 round-off
    (identical elementwise ops — in practice bit-equal on CPU); the two
    loops must terminate on the SAME round.
    """
    ref = replay_sync_scenario(cfg, np.asarray(out["interval"]),
                               max_rounds)
    n = int(out["n_rounds"])
    if n != int(ref["n_rounds"]):
        raise AssertionError(
            f"termination mismatch: compiled ran {n} rounds, replay "
            f"predicts {int(ref['n_rounds'])}")
    got_act = np.asarray(out["active_edges"])[:n]
    want_act = ref["active_edges"][:n]
    if not np.array_equal(got_act, want_act):
        bad = int(np.flatnonzero(got_act != want_act)[0])
        raise AssertionError(
            f"active-edge mismatch at round {bad}: compiled "
            f"{got_act[bad]}, replay {want_act[bad]}")
    for name in ("consumed", "wall"):
        got = np.asarray(out[name])[:n]
        want = ref[name][:n]
        if not np.allclose(got, want, rtol=1e-5, atol=1e-5):
            bad = int(np.flatnonzero(
                ~np.isclose(got, want, rtol=1e-5, atol=1e-5))[0])
            raise AssertionError(
                f"{name} mismatch at round {bad}: compiled "
                f"{got[bad]!r}, replay {want[bad]!r}")
    if not np.allclose(np.asarray(out["budgets_left"]),
                       ref["budgets_left"], rtol=1e-5, atol=1e-5):
        raise AssertionError(
            f"budgets_left mismatch: compiled "
            f"{np.asarray(out['budgets_left'])!r}, replay "
            f"{ref['budgets_left']!r}")
    return ref

"""Device telemetry rings for the compiled EL programs.

Once ``run_sync_ingraph`` / ``run_async_ingraph`` / a fleet cohort enter
their device loop, the paper's whole online trade-off (the bandit's arm
dynamics, budget burn, merge staleness) is invisible until the run ends.
This module adds fixed-size metric rings to the loop carries, as the
reference's ``repro.obs.rings`` does: each round or event writes its
signals at slot ``t % ring_size``, so the last ``ring_size`` rounds of
every signal come back in the program's output (``out["telemetry"]``)
with no host sync during the run.

The rings are gated when a cell is built: ``telemetry=None`` (the
default) builds exactly the ungated carry, with no extra key and no
extra op.  With a :class:`TelemetrySpec` the carry gains one ``"telem"``
subtree and each step records into it.  The spec is frozen and hashable:
it joins the session's program-cache keys and the fleet's cohort keys,
so on and off (and different ring sizes) never share a program.

Recorded signals (float32 / int32, the programs' own dtypes):

  sync  (per round)   ``arm``, ``round_cost`` (the straggler slot),
                      ``budget_resid`` (min residual after the charge),
                      ``arm_counts`` / ``arm_utility`` ``[ring, K]`` (the
                      bandit's per-arm statistics after the update)
  async (per event)   ``edge``, ``arm``, ``cost`` (the charge),
                      ``budget_resid`` (the event edge's residual),
                      ``alpha`` / ``staleness`` (the merge mix),
                      ``interarrival`` (the event's wall-time gap), and
                      the event edge's ``arm_counts`` / ``arm_utility``

With a ``ScenarioSpec`` both modes add ``active_edges``, ``dropouts`` and
``rejoins``.

Storage is packed by dtype group, the reference's layout: the float32
signals in one ``[ring, n_floats]`` buffer (column order
``_SYNC_FLOATS`` / ``_ASYNC_FLOATS``), the async int32 pair in one
``[ring, 2]`` (``_ASYNC_INTS``), beside the ``[ring, K]`` bandit
snapshots; ``finalize_telemetry`` unpacks the columns to the public
names.

A record writes its slot with a one-hot ``torch.where`` over the ring
(``arange(ring) == t % ring``), never ``index_put_``: the write needs no
host read of ``t``, so it runs inside a CUDA graph capture and under
``torch.func.vmap`` (the sweep's cells, a cohort's slots).  A K-event
wave writes its lanes one ``where`` each, masked by the lane's validity
(torch has no drop-mode scatter; a one-hot sum would turn ``-0.0`` into
``0.0``).

``sync_reference_telemetry`` / ``async_reference_telemetry`` replay the
rings in ``np.float32`` from a run's history arrays with the device's op
sequence: the oracle the rings are held to bit for bit at fixed cost.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

#: default ring length: covers a whole default sync run (max_rounds=512
#: rarely exceeds a few hundred charged rounds) at ~KB-scale state.
DEFAULT_RING = 128

#: packed-column orders (the storage layout; ``finalize_telemetry``
#: unpacks them back to these public names)
_SYNC_FLOATS = ("round_cost", "budget_resid")
_ASYNC_INTS = ("edge", "arm")
_ASYNC_FLOATS = ("cost", "budget_resid", "alpha", "staleness",
                 "interarrival")
#: scenario-path extras (both modes): fleet activity per round/event —
#: present only when the cell was built with BOTH a telemetry spec and a
#: ScenarioSpec (``sync_ring_init(..., scenario=True)``)
_SCN_INTS = ("active_edges", "dropouts", "rejoins")


@dataclasses.dataclass(frozen=True)
class TelemetrySpec:
    """Static telemetry configuration of a compiled EL program.

    Frozen + hashable so it participates in compile-cache keys and
    cohort bucketing: two runs share a compiled program only when their
    telemetry gating (and ring length) agree.
    """

    ring_size: int = DEFAULT_RING

    def __post_init__(self):
        if self.ring_size < 1:
            raise ValueError(
                f"ring_size must be >= 1, got {self.ring_size}")


def as_spec(telemetry: Union[None, bool, int, TelemetrySpec]
            ) -> Optional[TelemetrySpec]:
    """Normalize the user-facing ``telemetry=`` flag.

    ``None``/``False`` → off (the program is built exactly as the
    ungated one); ``True`` → default spec; an int → that ring size; a
    :class:`TelemetrySpec` passes through.
    """
    if telemetry is None or telemetry is False:
        return None
    if telemetry is True:
        return TelemetrySpec()
    if isinstance(telemetry, TelemetrySpec):
        return telemetry
    if isinstance(telemetry, int):
        return TelemetrySpec(ring_size=telemetry)
    raise TypeError(
        f"telemetry= expects None/bool/int/TelemetrySpec, got "
        f"{type(telemetry).__name__}")


# ---------------------------------------------------------------------------
# Device-side ring init/record (called from the cell closures)
# ---------------------------------------------------------------------------


def _int_ring(r: int, width: int, fill: int, device) -> torch.Tensor:
    return torch.full((r, width) if width else (r,), fill,
                      dtype=torch.int32, device=device)


def _slot(ring_size: int, t: torch.Tensor) -> torch.Tensor:
    """The one-hot ``[ring]`` mask of slot ``t % ring_size``."""
    return (torch.arange(ring_size, device=t.device)
            == torch.remainder(t, ring_size))


def _put(buf: torch.Tensor, hit: torch.Tensor, row) -> torch.Tensor:
    """``buf`` with the rows where ``hit`` [ring] holds set to ``row``."""
    return torch.where(hit.reshape((-1,) + (1,) * (buf.dim() - 1)),
                       row.to(buf.dtype), buf)


def _ints(values) -> torch.Tensor:
    """0-dim device tensors stacked as one int32 row."""
    return torch.stack([v.to(torch.int32).reshape(()) for v in values])


def sync_ring_init(spec: TelemetrySpec, n_arms: int, *,
                   scenario: bool = False, device=None) -> Dict[str, Any]:
    """The sync carry's ``"telem"`` subtree on ``device``: empty
    ``[ring]`` / ``[ring, n_floats]`` / ``[ring, K]`` buffers (``arm`` is
    -1 where nothing was recorded; float columns in ``_SYNC_FLOATS``
    order).  ``scenario=True`` (the scenario-path cells) adds a packed
    ``[ring, 3]`` int group in ``_SCN_INTS`` column order; ``False``
    builds exactly the classic subtree."""
    r = spec.ring_size
    ring = {
        "arm": _int_ring(r, 0, -1, device),
        "floats": torch.zeros((r, len(_SYNC_FLOATS)), device=device),
        "arm_counts": _int_ring(r, n_arms, 0, device),
        "arm_utility": torch.zeros((r, n_arms), device=device),
    }
    if scenario:
        ring["scn"] = _int_ring(r, len(_SCN_INTS), 0, device)
    return ring


def sync_ring_record(ring: Dict[str, Any], spec: TelemetrySpec, *,
                     t, arm, round_cost, budget_resid,
                     bstate: Dict[str, Any], scn=None) -> Dict[str, Any]:
    """Write round ``t``'s signals at slot ``t % ring_size`` (values the
    body already computed: recording adds writes, never math; the float
    group lands as one row).  ``scn=`` is the scenario path's
    ``(active_edges, dropouts, rejoins)`` int triple."""
    hit = _slot(spec.ring_size, t)
    out = {
        "arm": _put(ring["arm"], hit, arm),
        "floats": _put(ring["floats"], hit,
                       torch.stack([round_cost, budget_resid])),
        "arm_counts": _put(ring["arm_counts"], hit, bstate["counts"]),
        "arm_utility": _put(ring["arm_utility"], hit,
                            bstate["utility_sum"]),
    }
    if scn is not None:
        out["scn"] = _put(ring["scn"], hit, _ints(scn))
    return out


def async_ring_init(spec: TelemetrySpec, n_arms: int, *,
                    scenario: bool = False, device=None) -> Dict[str, Any]:
    """The async carry's ``"telem"`` subtree on ``device``: the packed
    ``[ring, 2]`` int group (``edge`` / ``arm``, -1 where nothing was
    recorded), the ``[ring, n_floats]`` float group (``_ASYNC_FLOATS``
    column order) and the ``[ring, K]`` bandit snapshots.
    ``scenario=True`` adds the ``[ring, 3]`` ``_SCN_INTS`` group (see
    :func:`sync_ring_init`)."""
    r = spec.ring_size
    ring = {
        "ints": _int_ring(r, len(_ASYNC_INTS), -1, device),
        "floats": torch.zeros((r, len(_ASYNC_FLOATS)), device=device),
        "arm_counts": _int_ring(r, n_arms, 0, device),
        "arm_utility": torch.zeros((r, n_arms), device=device),
    }
    if scenario:
        ring["scn"] = _int_ring(r, len(_SCN_INTS), 0, device)
    return ring


def async_ring_record(ring: Dict[str, Any], spec: TelemetrySpec, *,
                      t, edge, arm, cost, budget_resid, alpha, staleness,
                      interarrival, bstate_e: Dict[str, Any], scn=None
                      ) -> Dict[str, Any]:
    """Write event ``t``'s signals at slot ``t % ring_size``: one write
    per storage group, not one per scalar.  ``scn=`` is the scenario
    path's ``(active_edges, dropouts, rejoins)`` int triple."""
    hit = _slot(spec.ring_size, t)
    out = {
        "ints": _put(ring["ints"], hit, _ints((edge, arm))),
        "floats": _put(ring["floats"], hit, torch.stack(
            [cost, budget_resid, alpha, staleness, interarrival])),
        "arm_counts": _put(ring["arm_counts"], hit, bstate_e["counts"]),
        "arm_utility": _put(ring["arm_utility"], hit,
                            bstate_e["utility_sum"]),
    }
    if scn is not None:
        out["scn"] = _put(ring["scn"], hit, _ints(scn))
    return out


def async_ring_record_wave(ring: Dict[str, Any], spec: TelemetrySpec, *,
                           t0, valid, edge, arm, cost, budget_resid,
                           alpha, staleness, interarrival,
                           arm_counts, arm_utility) -> Dict[str, Any]:
    """Land a K-event wave's records in their per-event ring slots.

    Lane ``j`` is event ``t0 + j`` (waves accept a prefix of lanes), so
    its slot is ``(t0 + j) % ring_size``; a lane where ``valid`` is false
    writes nothing.  Each lane is one masked ``where`` per storage group;
    in-wave slots are distinct whenever the wave width is <=
    ``ring_size`` (enforced when the cell is built), so the ring equals K
    sequential :func:`async_ring_record` calls exactly, as the
    reference's drop-mode scatter does.
    """
    ints = torch.stack([edge.to(torch.int32), arm.to(torch.int32)],
                       dim=1)                                # [Kw, 2]
    floats = torch.stack([cost, budget_resid, alpha, staleness,
                          interarrival], dim=1)              # [Kw, 5]
    out = dict(ring)
    for j in range(edge.shape[0]):
        hit = _slot(spec.ring_size, t0 + j) & valid[j]
        out = {
            "ints": _put(out["ints"], hit, ints[j]),
            "floats": _put(out["floats"], hit, floats[j]),
            "arm_counts": _put(out["arm_counts"], hit, arm_counts[j]),
            "arm_utility": _put(out["arm_utility"], hit, arm_utility[j]),
        }
    return out


def finalize_telemetry(telem: Dict[str, Any], t,
                       spec: TelemetrySpec) -> Dict[str, Any]:
    """The ``out["telemetry"]`` subtree a gated finalize emits: the ring
    buffers unpacked to their public field names, plus the write head
    (= rounds recorded, int32) and the static ring size, so hosts can
    unroll wraparound without out-of-band state."""
    out: Dict[str, Any] = {}
    if "ints" in telem:                      # async packed layout
        for j, name in enumerate(_ASYNC_INTS):
            out[name] = telem["ints"][:, j]
        float_names = _ASYNC_FLOATS
    else:                                    # sync layout
        out["arm"] = telem["arm"]
        float_names = _SYNC_FLOATS
    for j, name in enumerate(float_names):
        out[name] = telem["floats"][:, j]
    out["arm_counts"] = telem["arm_counts"]
    out["arm_utility"] = telem["arm_utility"]
    if "scn" in telem:                       # scenario-path extras
        for j, name in enumerate(_SCN_INTS):
            out[name] = telem["scn"][:, j]
    return {**out, "head": t.to(torch.int32),
            "ring_size": torch.full((), spec.ring_size, dtype=torch.int32,
                                    device=t.device)}


# ---------------------------------------------------------------------------
# Host-side ring reading
# ---------------------------------------------------------------------------


def ring_order(head: int, ring_size: int) -> List[Tuple[int, int]]:
    """The ``(round_t, slot)`` pairs a ring holds, oldest first: rounds
    ``max(0, head - ring_size) .. head - 1`` at slots ``t % ring_size``.
    """
    head, ring_size = int(head), int(ring_size)
    return [(t, t % ring_size) for t in range(max(0, head - ring_size),
                                              head)]


def unroll_ring(telemetry: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Reorder an ``out["telemetry"]`` dict's buffers into round order
    (oldest retained round first), dropping never-written slots."""
    order = ring_order(telemetry["head"], telemetry["ring_size"])
    slots = [s for _, s in order]
    return {k: np.asarray(v)[slots] for k, v in telemetry.items()
            if k not in ("head", "ring_size")}


# ---------------------------------------------------------------------------
# Host-side reference replays (the equivalence oracle for the tests)
# ---------------------------------------------------------------------------


def _replay_bandit(arms: np.ndarray, utilities: np.ndarray,
                   costs: np.ndarray, n_arms: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Replay ``jax_bandit_update`` for one bandit: per-step post-update
    (counts, utility_sum) snapshots, accumulated in np.float32 in pull
    order — the device's exact op sequence."""
    counts = np.zeros(n_arms, np.int32)
    usum = np.zeros(n_arms, np.float32)
    out_c = np.zeros((len(arms), n_arms), np.int32)
    out_u = np.zeros((len(arms), n_arms), np.float32)
    for t, (a, u) in enumerate(zip(arms, utilities)):
        counts[a] += 1
        usum[a] = np.float32(usum[a] + np.float32(u))
        out_c[t] = counts
        out_u[t] = usum
    del costs                      # cost_sum is not ring-recorded
    return out_c, out_u


def sync_reference_telemetry(out: Dict[str, Any],
                             knobs: Dict[str, np.ndarray],
                             n_arms: int) -> Dict[str, np.ndarray]:
    """Replay the sync rings from the program's history arrays.

    Valid for fixed-cost runs (``cost_noise == 0``, where the noise
    multiplier is exactly 1.0): every replayed quantity repeats the
    device's f32 op sequence on the same values —

      * ``round_cost``  = ``max_e(interval * comp_e + comm_e)``;
      * ``budget_resid``= ``budget - wall_t`` (in sync every edge's
        consumed equals the cumulative straggler wall, accumulated by
        the identical additions, so the device's ``min(budget -
        consumed)`` is this very subtraction);
      * the bandit statistics replay ``jax_bandit_update`` from the
        (interval, utility) history.

    Returns round-ordered arrays shaped like :func:`unroll_ring` of the
    device telemetry.
    """
    tele = out["telemetry"]
    head = int(np.asarray(tele["head"]))
    ring = int(np.asarray(tele["ring_size"]))
    interval = np.asarray(out["interval"])[:head]
    utility = np.asarray(out["utility"])[:head].astype(np.float32)
    wall = np.asarray(out["wall"])[:head].astype(np.float32)
    comp = np.asarray(knobs["comp"], np.float32)
    comm = np.asarray(knobs["comm"], np.float32)
    budget = np.float32(knobs["budget"])

    arms = (interval - 1).astype(np.int32)
    round_cost = np.array(
        [np.max(np.float32(i) * comp + comm) for i in
         interval.astype(np.float32)], np.float32)
    budget_resid = np.float32(budget - wall)
    counts, usum = _replay_bandit(arms, utility, round_cost, n_arms)

    lo = max(0, head - ring)
    return {
        "arm": arms[lo:head],
        "round_cost": round_cost[lo:head],
        "budget_resid": budget_resid[lo:head],
        "arm_counts": counts[lo:head],
        "arm_utility": usum[lo:head],
    }


def async_reference_telemetry(out: Dict[str, Any],
                              knobs: Dict[str, np.ndarray],
                              n_edges: int, n_arms: int
                              ) -> Dict[str, np.ndarray]:
    """Replay the async rings from the program's history arrays.

    Replays the event loop's bookkeeping — per-edge budget
    accumulation, the model-version / fetch-version staleness chain
    (``staleness_alpha``'s exact f32 expression), event inter-arrival —
    from the recorded (edge, interval, utility, cost, wall) history.
    Valid whenever the history is (both cost modes: ``cost`` is the
    realized charge).
    """
    tele = out["telemetry"]
    head = int(np.asarray(tele["head"]))
    ring = int(np.asarray(tele["ring_size"]))
    edge = np.asarray(out["edge"])[:head].astype(np.int32)
    interval = np.asarray(out["interval"])[:head].astype(np.int32)
    utility = np.asarray(out["utility"])[:head].astype(np.float32)
    cost = np.asarray(out["cost"])[:head].astype(np.float32)
    wall = np.asarray(out["wall"])[:head].astype(np.float32)
    budget = np.float32(knobs["budget"])
    alpha0 = np.float32(knobs["async_alpha"])

    arms = (interval - 1).astype(np.int32)
    consumed = np.zeros(n_edges, np.float32)
    fetch_ver = np.zeros(n_edges, np.int64)
    version = 0
    resid = np.zeros(head, np.float32)
    alpha = np.zeros(head, np.float32)
    stale = np.zeros(head, np.float32)
    inter = np.zeros(head, np.float32)
    # per-edge bandits: replay each edge's pull sequence independently
    counts = np.zeros((n_edges, n_arms), np.int32)
    usum = np.zeros((n_edges, n_arms), np.float32)
    out_c = np.zeros((head, n_arms), np.int32)
    out_u = np.zeros((head, n_arms), np.float32)
    prev_wall = np.float32(0.0)
    for t in range(head):
        e = int(edge[t])
        consumed[e] = np.float32(consumed[e] + cost[t])
        resid[t] = np.float32(budget - consumed[e])
        s = np.float32(np.float32(version - fetch_ver[e])
                       / np.float32(max(n_edges, 1)))
        stale[t] = s
        alpha[t] = np.float32(alpha0 / np.float32(1.0 + s))
        inter[t] = np.float32(wall[t] - prev_wall)
        prev_wall = wall[t]
        a = int(arms[t])
        counts[e, a] += 1
        usum[e, a] = np.float32(usum[e, a] + utility[t])
        out_c[t] = counts[e]
        out_u[t] = usum[e]
        version += 1
        fetch_ver[e] = version

    lo = max(0, head - ring)
    return {
        "edge": edge[lo:head],
        "arm": arms[lo:head],
        "cost": cost[lo:head],
        "budget_resid": resid[lo:head],
        "alpha": alpha[lo:head],
        "staleness": stale[lo:head],
        "interarrival": inter[lo:head],
        "arm_counts": out_c[lo:head],
        "arm_utility": out_u[lo:head],
    }

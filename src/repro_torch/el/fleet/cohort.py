"""One cohort = one structural config = ONE compiled slot-batch program.

A :class:`Cohort` owns the runtime state behind a
:class:`repro_torch.el.sweep.engine.CellBatch`: the stacked device carry,
the per-slot tenant bindings, knob rows and draw providers, and a
priority admission queue.  ``wave()`` is the whole service loop body —
admit pending tenants into free slots, run ``rounds_per_wave`` masked
steps (one CUDA graph replay on a card), stream each slot's newly
completed aggregations as :class:`RoundDelta` events, and finalize slots
whose runs terminated (freeing them for the next admission).

The stacked carry is updated in place: the cohort hands ``CellBatch.
step`` the same object every wave, which the batch adopts as its
captured graph's static buffer on first sight (any other object would
cost a copy of the whole carry a wave), so a cohort serving thousands of
tenants recycles one set of device buffers.  A ``CellBatch`` holds that
state, so it serves one live cohort at a time (:meth:`Cohort._claim`).

Over ranks (a ``CellBatch`` with a slot shard) every rank runs the same
cohort: admission, the knob rows and every decision here are host-side
and replicated, the batch places and steps the slots this rank owns, and
what is read across slots comes back all-gathered, so every rank emits
the same events and reports.

With ``profile=True`` the first wave profiles the batch's wave program
(``repro_torch.obs.prof.profile_jit``, the stacked carry ``donated``: the
graph updates it in place) once per cohort, stores the profile on the
shared program cache and attaches it to every tenant report.
"""

from __future__ import annotations

import heapq
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.el.fleet.tenant import ReportReady, RoundDelta, TenantRun
from repro_torch.el.report import (ELReport, RoundRecord, records_from_out,
                                   report_from_out)
from repro_torch.el.rng import TorchDraws
from repro_torch.el.sweep.engine import CellBatch
from repro_torch.interop import tree_map

EmitFn = Callable[[Any], None]

#: the history entries a ``RoundRecord`` reads (``records_from_out``)
_RECORD_KEYS = ("wall", "consumed", "metric", "utility", "interval", "edge")


class _Active:
    """A tenant occupying a slot: its submission, resolved knob row,
    streamed-record cursor and admission wall-clock."""

    __slots__ = ("tenant_id", "run", "knobs", "records", "t0")

    def __init__(self, tenant_id: str, run: TenantRun,
                 knobs: Dict[str, np.ndarray]):
        self.tenant_id = tenant_id
        self.run = run
        self.knobs = knobs
        self.records: List[RoundRecord] = []
        self.t0 = time.perf_counter()


def _hist_rows(batch: CellBatch, hist: Dict[str, torch.Tensor], lo: int,
               hi: int) -> Dict[str, np.ndarray]:
    """Rows ``[lo, hi)`` of every slot's record history on the host, in
    one device-to-host copy (over ranks, after one all-gather of every
    rank's slots): the entries (all 4-byte f32 / int32) are packed as
    int32 bits and viewed back as their own dtypes."""
    keys = [k for k in _RECORD_KEYS if k in hist]
    packed = batch.gather_slots(torch.stack(
        [hist[k][:, lo:hi].view(torch.int32) for k in keys], 1))
    packed = packed.cpu().numpy()
    return {k: packed[:, i].view(np.float32 if hist[k].is_floating_point()
                                 else np.int32)
            for i, k in enumerate(keys)}


class Cohort:
    """Slot-batched continuous service of one structural config."""

    def __init__(self, key: tuple, batch: CellBatch, knobs_fn: Callable, *,
                 profile: bool = False, cache=None):
        self.key = key
        self.batch = batch
        self.knobs_fn = knobs_fn
        self.profile_requested = bool(profile)
        self._cache = cache
        self._profile = None
        self.waves = 0
        self.admitted = 0
        self.completed = 0
        # wave-batched data-plane dispatch counters: admits land as ONE
        # place_many scatter per wave and finalize reads as ONE
        # take_many gather per wave, regardless of how many tenants
        # joined/finished (the fleet launcher checks these stay at or
        # below one dispatch per wave)
        self.place_dispatches = 0
        self.gather_dispatches = 0
        self._seq = 0
        self._pending: List[Tuple[int, int, str, TenantRun]] = []
        self._slots: List[Optional[_Active]] = [None] * batch.n_slots
        self._stacked = None                     # device carry [n_slots,...]
        self._knobs_np: Optional[Dict[str, np.ndarray]] = None

    # -- admission ----------------------------------------------------------

    def submit(self, tenant_id: str, run: TenantRun) -> None:
        """Queue a tenant (higher ``priority`` first, FIFO within)."""
        heapq.heappush(self._pending,
                       (-run.priority, self._seq, tenant_id, run))
        self._seq += 1

    @property
    def has_work(self) -> bool:
        return bool(self._pending) or any(s is not None
                                          for s in self._slots)

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def n_pending(self) -> int:
        return len(self._pending)

    def _claim(self) -> None:
        """Make this cohort the batch's user.  The batch's static buffers
        (carry, knobs, draw providers) hold one cohort's tenants, so a
        cohort of another server sharing the program cache may take it
        over only when it has no work left; this cohort then rebuilds
        its stacked carry at the next admission."""
        owner = self.batch.owner
        if owner is self:
            return
        if owner is not None and owner.has_work:
            raise RuntimeError(
                "this cohort's compiled slot batch is serving another "
                "server's live cohort; drain or close that server first, "
                "or give this server its own ProgramCache")
        self.batch.owner = self
        self._stacked = None

    def _admit(self) -> int:
        """Fill free slots from the queue (continuous batching: runs
        admitted mid-flight join the next wave; occupied slots are
        untouched — the scatter only writes the freed rows).  The whole
        wave's admissions land in ONE ``place_many`` dispatch: each
        slot's carry (and its initial draws) is built by ``init_slot``,
        then all are scattered together with their draw providers.
        Returns the number of tenants admitted; each admission emits a
        ``cohort.refill`` trace event."""
        from repro_torch.obs import trace
        if not self._pending or all(s is not None for s in self._slots):
            return 0
        self._claim()
        admitted: List[Tuple[int, Any, Any]] = []   # (slot, carry, draws)
        for s in range(self.batch.n_slots):
            if self._slots[s] is not None or not self._pending:
                continue
            _, _, tenant_id, run = heapq.heappop(self._pending)
            knobs = self.knobs_fn(run.cfg)
            params = (run.init_params if run.init_params is not None
                      else run.executor.init_params(run.cfg.seed))
            # ONE provider per admission: init_slot takes its initial
            # draws and the slot reads the rest from the same object
            draws = run.draws
            if draws is None:
                draws = TorchDraws(torch.Generator(device=self.batch.device)
                                   .manual_seed(run.cfg.seed + 17))
            carry = self.batch.init_slot(params, knobs, draws)
            if self._stacked is None:
                self._stacked = self.batch.broadcast(carry)
                # every row starts as this tenant's knobs: a free row's
                # step is masked, but its knobs stay in range
                self._knobs_np = {
                    k: np.repeat(np.asarray(v)[None], self.batch.n_slots,
                                 axis=0)
                    for k, v in knobs.items()}
            for k, v in knobs.items():
                self._knobs_np[k][s] = v
            self._slots[s] = _Active(tenant_id, run, knobs)
            self.admitted += 1
            admitted.append((s, carry, draws))
            trace.event("cohort.refill", slot=s, tenant=tenant_id,
                        queue_depth=len(self._pending))
        # fixed-arity scatter: pad to n_slots by repeating the last
        # (carry, slot, draws) — the same objects, so the duplicate
        # writes are idempotent
        pad = [admitted[-1]] * (self.batch.n_slots - len(admitted))
        slots, carries, draws = zip(*(admitted + pad))
        self._stacked = self.batch.place_many(self._stacked, carries,
                                              slots, draws)
        self.place_dispatches += 1
        return len(admitted)

    # -- the service loop body ----------------------------------------------

    def wave(self, emit: EmitFn) -> List[Tuple[str, ELReport]]:
        """Admit, step one wave, stream deltas, finalize finished slots.

        Returns the ``(tenant_id, report)`` pairs completed this wave
        (also emitted as :class:`ReportReady` events, after that
        tenant's final :class:`RoundDelta`\\ s).  The whole body runs
        inside a ``trace.span("cohort.wave")`` recording slot occupancy,
        queue depth, refill count and completions.
        """
        from repro_torch.obs import trace
        with trace.span("cohort.wave", mode=self.batch.mode) as sp:
            refilled = self._admit()
            sp["refilled"] = refilled
            sp["queue_depth"] = len(self._pending)
            active = [s is not None for s in self._slots]
            sp["slots_active"] = sum(active)
            if not any(active):
                sp["completed"] = 0
                return []
            if self.profile_requested and self._profile is None:
                self._profile_step(active)
            self._stacked, running = self.batch.step(
                self._stacked, self._knobs_np, torch.tensor(active))
            self.waves += 1
            done = self._harvest(running.tolist(), emit)
            sp["completed"] = len(done)
            return done

    def _harvest(self, running: List[bool], emit: EmitFn
                 ) -> List[Tuple[str, ELReport]]:
        """Stream the wave's newly completed aggregations from the live
        history — the same arrays the final report is built from, so
        accumulated deltas == report.records bit for bit — reading only
        the rows written since the last wave; then finalize the slots
        that stopped running."""
        t_host = self.batch.last_t
        new = [(s, len(slot.records), t_host[s])
               for s, slot in enumerate(self._slots)
               if slot is not None and t_host[s] > len(slot.records)]
        if new:
            lo, hi = min(n[1] for n in new), max(n[2] for n in new)
            rows = _hist_rows(self.batch, self._stacked["hist"], lo, hi)
            for s, a, b in new:
                slot = self._slots[s]
                fresh = records_from_out({k: v[s] for k, v in rows.items()},
                                         a, b, base=lo)
                slot.records.extend(fresh)
                for rec in fresh:
                    emit(RoundDelta(slot.tenant_id, rec))
        finished = [s for s, slot in enumerate(self._slots)
                    if slot is not None and not running[s]]
        if not finished:
            return []
        # the wave's finished rows come off the stacked carry in ONE
        # take_many gather (fixed shape: pad the slot list by repeating
        # the last index), then finalize per tenant from the gathered
        # sub-stack
        pad = self.batch.n_slots - len(finished)
        rows = self.batch.take_many(self._stacked,
                                    finished + [finished[-1]] * pad)
        self.gather_dispatches += 1
        return [self._finalize(s, emit,
                               tree_map(lambda a, i=i: a[i], rows))
                for i, s in enumerate(finished)]

    def _profile_step(self, active: List[bool]) -> None:
        """Profile the batch's wave program on the live stacked carry
        (adopted as the wave adopts it; no draw is taken), once per
        cohort; the profile is also stored on the shared program cache."""
        from repro_torch.obs import prof as obs_prof
        from repro_torch.obs import trace
        with trace.span("cohort.profile", mode=self.batch.mode):
            prof = obs_prof.profile_jit(self.batch, self._stacked,
                                        self._knobs_np, torch.tensor(active),
                                        donated=True)
        self._profile = prof
        if self._cache is not None:
            self._cache.set_profile(self.key, prof)

    def _finalize(self, s: int, emit: EmitFn,
                  carry: Any) -> Tuple[str, ELReport]:
        slot = self._slots[s]
        params, out = self.batch.finalize_slot(carry, slot.knobs)
        final = slot.run.executor.evaluate(params)[slot.run.metric_name]
        report = report_from_out(
            out, mode=self.batch.mode, policy=slot.run.cfg.policy,
            horizon=self.batch.horizon, final_metric=final,
            final_params=params,
            elapsed_s=time.perf_counter() - slot.t0,
            records=slot.records)
        if self._profile is not None:
            report.telemetry = dict(report.telemetry or {},
                                    profile=self._profile.to_json())
        report.raw = out
        self._slots[s] = None                    # frees the row; the mask
        self.completed += 1                      # keeps it inert until reuse
        emit(ReportReady(slot.tenant_id, report))
        return slot.tenant_id, report

    def release(self) -> None:
        """Drop the stacked carry and give up the batch (its static
        buffers stay with the cached program until it is evicted or
        cleared); queued/active tenants are discarded."""
        self._stacked = None
        self._knobs_np = None
        self._slots = [None] * self.batch.n_slots
        self._pending = []
        if self.batch.owner is self:
            self.batch.owner = None

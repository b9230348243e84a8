"""``ELSession`` — the façade over the OL4EL runtime, host loops.

    from repro_torch.el import ELSession

    report = (ELSession(cfg)
              .with_executor(executor)            # any EdgeExecutor
              .with_policy("ol4el")               # name or Policy object
              .on_round(lambda rec: ...)          # streaming callbacks
              .run())                             # -> ELReport

One session owns the paper pipeline: the cloud coordinator (budgets +
bandit, numpy on the host), the utility estimator, and the host-driven
sync/async loops (the §V simulator semantics) over an executor whose
training and aggregation run in torch on the executor's device.  The
random streams are the reference's numpy ones (coordinator
``default_rng(seed)``, block seeds ``default_rng(seed + 17)``, minibatch
indices in the executor), so a seeded run makes the reference's decisions.

``run_sync_ingraph`` runs the whole budgeted sync loop on the device
(``repro_torch.el.ingraph``), ``run_async_ingraph`` the async event loop
(``repro_torch.el.events``): chunks of masked rounds or events, each a
CUDA graph replay on a card, with the bandits on the device and one host
sync per chunk.  Their draws come through the RNG seam
(``repro_torch.el.rng``); ``run_async(rng_streams="jax")`` is the async
program's host twin on the same draws.  ``sweep`` runs a whole ablation
grid as one of those device loops with a leading cell dimension
(``repro_torch.el.sweep``).  ``telemetry=`` turns the device rings on
(``repro_torch.obs.rings``), ``profile=`` / ``contract=`` the program
profiles and their contracts (``repro_torch.obs.prof``).
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.config import ExperimentConfig, OL4ELConfig
from repro_torch.core.coordinator import CloudCoordinator
from repro_torch.core.utility import UtilityEstimator, param_l2_delta
from repro_torch.el import policies as el_policies
from repro_torch.el.cache import ProgramCache
from repro_torch.el.events.knobs import default_event_horizon
from repro_torch.el.executor import EdgeExecutor, validate_executor
from repro_torch.el.report import (ELReport, RoundRecord, records_from_out,
                                   report_from_out)
from repro_torch.federated.aggregation import (staleness_alpha, staleness_mix,
                                               weighted_average)

Params = Any
RoundCallback = Callable[[RoundRecord], None]

#: ``run_sync_ingraph``'s default compiled history length (``max_rounds``)
DEFAULT_SYNC_HORIZON = 512


class ELSession:
    """Configure-then-run handle for one edge-cloud collaborative run."""

    def __init__(self, cfg: Union[OL4ELConfig, ExperimentConfig], *,
                 metric_name: str = "accuracy", lr: float = 0.1,
                 async_alpha: Optional[float] = None):
        if isinstance(cfg, ExperimentConfig):
            cfg = cfg.ol4el
        if async_alpha is not None:        # override the config's knob
            cfg = dataclasses.replace(cfg, async_alpha=float(async_alpha))
        self.cfg = cfg
        self.metric_name = metric_name
        self.lr = lr
        self._executor: Optional[EdgeExecutor] = None
        self._init_params: Optional[Params] = None
        self._n_samples: Optional[np.ndarray] = None
        self._policy: Optional[el_policies.Policy] = None
        self._callbacks: List[RoundCallback] = []
        self.coord: Optional[CloudCoordinator] = None   # built per run
        self._coord_consumed = False
        # compiled-program cache: key -> SyncProgram / AsyncProgram (its
        # static device buffers and, on a card, its captured CUDA graph).  Bounded FIFO:
        # each entry pins a device copy of the padded per-edge datasets.
        self._programs = ProgramCache(max_entries=8)
        self._closed = False
        self._fastpath = None                      # last compiled program
        self._sweep_programs: List[Any] = []       # the last sweep's

    @property
    def async_alpha(self) -> float:
        """The async staleness-mix base rate (``cfg.async_alpha``)."""
        return self.cfg.async_alpha

    # -- configuration API ---------------------------------------------------

    def with_executor(self, executor: EdgeExecutor, *,
                      init_params: Optional[Params] = None,
                      n_samples: Optional[Any] = None) -> "ELSession":
        validate_executor(executor)
        self._executor = executor
        self._init_params = init_params
        if n_samples is not None:
            self._n_samples = np.asarray(n_samples, np.float64)
        return self

    def with_policy(self, policy: Union[str, el_policies.Policy]
                    ) -> "ELSession":
        if isinstance(policy, str):
            self.cfg = dataclasses.replace(self.cfg, policy=policy)
            self._policy = None
        else:
            self._policy = policy
            self.cfg = dataclasses.replace(self.cfg, policy=policy.name)
        self.coord = None                    # any prepared coordinator is stale
        return self

    def with_metric(self, metric_name: str) -> "ELSession":
        self.metric_name = metric_name
        return self

    def on_round(self, callback: RoundCallback) -> "ELSession":
        """Register a streaming per-aggregation callback."""
        self._callbacks.append(callback)
        return self

    # -- internals -----------------------------------------------------------

    def _require_executor(self) -> EdgeExecutor:
        if self._closed:
            raise RuntimeError(
                "this ELSession is closed (close() released its compiled "
                "programs and device buffers); build a fresh session")
        if self._executor is None:
            raise RuntimeError("call .with_executor(...) before .run()")
        return self._executor

    def _mark_donated(self) -> None:
        """Flag the session's init params as given to a ``donate=True``
        run: ``_initial_params`` refuses them from now on."""
        from repro_torch.interop import tree_leaves
        if self._init_params is not None:
            for leaf in tree_leaves(self._init_params):
                leaf._repro_donated = True

    def _initial_params(self) -> Params:
        if self._init_params is not None:
            from repro_torch.interop import tree_leaves
            if any(getattr(leaf, "_repro_donated", False)
                   for leaf in tree_leaves(self._init_params)):
                raise RuntimeError(
                    "the session's init_params were donated to a previous "
                    "donate=True run (the run updated their storage in "
                    "place); pass fresh init_params via .with_executor() "
                    "before running again")
            return self._init_params
        ex = self._require_executor()
        if hasattr(ex, "init_params"):
            return ex.init_params(self.cfg.seed)
        raise RuntimeError(
            f"{type(ex).__name__} has no init_params(); pass "
            "init_params= to with_executor()")

    def coordinator(self) -> CloudCoordinator:
        """The current coordinator: before a run this is the instance the
        next run will use (budgets/costs inspectable — or adjustable);
        after a run it still holds that run's consumed state."""
        if self.coord is None:
            self.coord = CloudCoordinator(self.cfg, self.cfg.n_edges,
                                          lr=self.lr, policy=self._policy)
            self._coord_consumed = False
        return self.coord

    def _build(self) -> Tuple[CloudCoordinator, UtilityEstimator,
                              np.random.Generator]:
        if self._coord_consumed:             # each run starts from fresh
            self.coord = None                # budgets/bandit statistics
        coord = self.coordinator()
        self._coord_consumed = True
        utility = UtilityEstimator(self.cfg.utility)
        rng = np.random.default_rng(self.cfg.seed + 17)
        return coord, utility, rng

    def _emit(self, records: List[RoundRecord], rec: RoundRecord) -> None:
        records.append(rec)
        for cb in self._callbacks:
            cb(rec)

    def _snapshot(self, ex: EdgeExecutor, utility: UtilityEstimator,
                  params: Params, want_metric: bool) -> Dict[str, Any]:
        snap: Dict[str, Any] = {"params": params, "loss": 0.0}
        if want_metric or utility.kind in ("eval_gain", "loss_delta"):
            m = ex.evaluate(params)
            snap["metric"] = m[self.metric_name]
            snap["loss"] = m.get("loss", 0.0)
        else:
            snap["metric"] = float("nan")
        return snap

    def _report(self, ex: EdgeExecutor, coord: CloudCoordinator,
                params: Params, records: List[RoundRecord], reason: str,
                t0: float) -> ELReport:
        final = ex.evaluate(params)[self.metric_name]
        pulls = np.zeros(self.cfg.max_interval, np.int64)
        for b in coord.bandits:
            pulls += np.asarray(b.counts)
        return ELReport(
            records=records,
            final_metric=float(final),
            n_aggregations=len(records),
            total_consumed=coord.total_consumed(),
            wall_time=records[-1].wall_time if records else 0.0,
            terminated_reason=reason,
            policy=self.cfg.policy,
            mode=self.cfg.mode,
            arm_pulls=[int(c) for c in pulls],
            elapsed_s=time.perf_counter() - t0,
            final_params=params,
        )

    # -- host-driven synchronous loop ----------------------------------------

    def run_sync(self, max_rounds: int = 10_000,
                 eval_every: int = 1) -> ELReport:
        cfg = self.cfg
        ex = self._require_executor()
        coord, utility, rng = self._build()
        t0 = time.perf_counter()
        params = self._initial_params()
        records: List[RoundRecord] = []
        wall, n_agg = 0.0, 0
        prev = self._snapshot(ex, utility, params, want_metric=True)
        reason = "max_rounds"
        for _ in range(max_rounds):
            interval = coord.decide()
            if interval < 0 or coord.all_exhausted():
                reason = "budget_exhausted"
                break
            edge_params: List[Params] = []
            round_costs = np.zeros(cfg.n_edges)
            for e in range(cfg.n_edges):
                p_e, _ = ex.local_train(params, e, interval,
                                        rng.integers(1 << 31))
                edge_params.append(p_e)
                round_costs[e] = coord.realized_cost(e, interval)
            # Time-budget semantics (paper §V.A): synchronous edges BLOCK
            # on the slowest edge, so every edge's budget advances by the
            # straggler's round time.
            slot = float(round_costs.max())
            for e in range(cfg.n_edges):
                coord.charge(e, slot)
            wall += slot
            w = (np.ones(cfg.n_edges) if self._n_samples is None
                 else self._n_samples)
            params = weighted_average(edge_params, w)
            n_agg += 1
            new = self._snapshot(ex, utility, params,
                                 want_metric=(n_agg % eval_every == 0))
            u = utility(prev, new)
            # sync: ONE bandit fed the worst-case (binding) cost
            coord.observe(0, interval, u, slot)
            if coord.ac is not None:
                self._update_ac(coord, edge_params, prev["params"], params,
                                interval)
            prev = new
            self._emit(records, RoundRecord(
                wall, coord.total_consumed(), new["metric"], u,
                interval, -1, n_agg))
        return self._report(ex, coord, params, records, reason, t0)

    # -- host-driven asynchronous (event-driven) loop ------------------------

    def run_async(self, max_events: Optional[int] = None,
                  eval_every: int = 1, rng_streams: str = "numpy", *,
                  draws=None) -> ELReport:
        """The host-driven event-queue loop (paper §V.A async semantics).

        ``max_events=None`` derives the horizon from budget/cost
        (``default_event_horizon``), so long runs are never silently
        truncated.

        ``rng_streams`` picks the randomness source: ``"numpy"`` (the
        reference's host streams) or ``"jax"``, the reference's name for
        "the compiled async program's streams": the same priority-queue
        loop driven by the program's RNG-seam draws (``draws``, default a
        ``torch.Generator`` seeded as ``run_async_ingraph`` seeds its own)
        and its f32 per-event pieces (``repro_torch.el.events.reference``;
        needs the in-graph support matrix).  At fixed cost the ``"jax"``
        loop is bit-identical to ``run_async_ingraph()`` on the same
        draws; ``eval_every`` is ignored there.  The reference's twin has
        no scenario branch: with ``cfg.scenario`` set it runs the
        scenario-less event loop (the scenario knobs unread), and so does
        this one.
        """
        cfg = self.cfg
        ex = self._require_executor()
        if rng_streams == "jax":
            from repro_torch.el.events.reference import run_async_reference
            acfg = self._ingraph_cfg("run_async(rng_streams='jax')",
                                     mode="async")
            return run_async_reference(
                ex, acfg, self._initial_params(),
                metric_name=self.metric_name, max_events=max_events,
                draws=draws, callbacks=self._callbacks)
        if rng_streams != "numpy":
            raise ValueError(
                f"unknown rng_streams={rng_streams!r}; expected 'numpy' "
                "or 'jax'")
        if max_events is None:
            max_events = default_event_horizon(cfg)
        coord, utility, rng = self._build()
        t0 = time.perf_counter()
        global_params = self._initial_params()
        records: List[RoundRecord] = []
        n_agg = 0
        prev = self._snapshot(ex, utility, global_params, want_metric=True)
        # per-edge in-flight blocks: (finish_time, edge, interval, cost) —
        # the SAME realized-cost draw sets the finish time AND is charged
        # at completion, so charged budget always equals simulated
        # wall-clock (one draw per block, not two independent ones).
        heap: List[Tuple[float, int, int, float]] = []
        fetch_version = np.zeros(cfg.n_edges)
        version = 0
        edge_params: List[Params] = [global_params] * cfg.n_edges
        for e in range(cfg.n_edges):
            i = coord.decide(e)
            if i < 0:
                continue
            cost = coord.realized_cost(e, i)
            heapq.heappush(heap, (cost, e, i, cost))
            fetch_version[e] = version
        wall = 0.0
        reason = "max_events"
        for _ in range(max_events):
            if not heap:
                reason = "budget_exhausted"
                break
            wall, e, interval, cost = heapq.heappop(heap)
            # edge e finishes `interval` local iterations and uploads
            p_e, _ = ex.local_train(edge_params[e], e, interval,
                                    rng.integers(1 << 31))
            coord.charge(e, cost)
            # staleness in *epochs*: normalize raw version staleness by the
            # fleet size so async mixing survives edge-count scaling
            staleness = (version - fetch_version[e]) / max(cfg.n_edges, 1)
            alpha = staleness_alpha(self.async_alpha, staleness)
            global_params = staleness_mix(global_params, p_e, alpha)
            version += 1
            n_agg += 1
            new = self._snapshot(ex, utility, global_params,
                                 want_metric=(n_agg % eval_every == 0))
            u = utility(prev, new)
            coord.observe(e, interval, u, cost)
            prev = new
            self._emit(records, RoundRecord(
                wall, coord.total_consumed(), new["metric"], u,
                float(interval), e, n_agg))
            # edge fetches the fresh global model, schedules its next block
            edge_params[e] = global_params
            fetch_version[e] = version
            nxt = coord.decide(e)
            if nxt > 0 and not coord.exhausted(e):
                next_cost = coord.realized_cost(e, nxt)
                heapq.heappush(heap, (wall + next_cost, e, nxt, next_cost))
        return self._report(ex, coord, global_params, records, reason, t0)

    def run(self, **kw) -> ELReport:
        if self.cfg.mode == "sync":
            return self.run_sync(**kw)
        return self.run_async(**kw)

    # -- compiled fast path --------------------------------------------------

    def _attach_cache_stats(self, report: ELReport,
                            key: Optional[tuple] = None) -> ELReport:
        """Fold the session's program-cache counters into
        ``report.telemetry["cache"]`` (always present on device-loop
        reports, rings on or off).  When ``key`` names a cached program
        that has been profiled, its :class:`repro_torch.obs.prof.
        ProgramProfile` snapshot joins as ``report.telemetry["profile"]``."""
        tele = dict(report.telemetry or {})
        tele["cache"] = self._programs.stats()
        if key is not None:
            prof = self._programs.profile(key)
            if prof is not None:
                tele["profile"] = prof.to_json()
        report.telemetry = tele
        return report

    def _profile_program(self, key: tuple, program: Any,
                         example_args: tuple, *, mode: str, profile: bool,
                         contract, scenario: bool = False, mesh=None,
                         donate: bool = False) -> Any:
        """The dispatch-time half of the program profiles
        (``repro_torch.obs.prof``): profile the cached program once per
        cache entry and, when a contract is armed, enforce it.

        ``profile`` / ``contract`` are the per-call opt-ins;
        ``REPRO_EL_PROFILE=1`` / ``REPRO_EL_CONTRACTS=1`` arm them
        process-wide.  ``contract=True`` checks the mode's
        ``default_contract`` for ``mesh`` and ``donate`` (one rank: no
        collectives; sharded: gather-before-reduce; donated: the params
        aliased, else nothing); a ``CollectiveContract`` instance checks
        that.  A violation raises
        ``repro_torch.obs.prof.ContractViolation`` before any chunk of
        the run is replayed.
        """
        import os
        from repro_torch.obs import prof as obs_prof
        from repro_torch.obs import trace
        if contract is None and os.environ.get("REPRO_EL_CONTRACTS"):
            contract = True
        want_profile = (profile or bool(contract)
                        or bool(os.environ.get("REPRO_EL_PROFILE")))
        if not want_profile:
            return self._programs.profile(key)
        prof = self._programs.profile(key)
        if prof is None:
            with trace.span("session.profile", mode=mode):
                prof = obs_prof.profile_jit(program, *example_args,
                                            donated=donate)
                self._programs.set_profile(key, prof)
        if contract:
            c = contract
            if c is True:
                c = obs_prof.default_contract(
                    mode=mode, scenario=scenario, donated=donate,
                    mesh=mesh if getattr(program.cell, "sharded",
                                         False) else None,
                    param_bytes=obs_prof.param_tree_bytes(example_args[0]))
            c.enforce(prof)
        return prof

    @staticmethod
    def _structural_cfg(cfg: OL4ELConfig) -> OL4ELConfig:
        """The config with the knob fields normalized away: ucb_c, budget,
        heterogeneity, cost noise, the async mixing rate and seed enter
        the compiled program as inputs (``sync_knobs``, the draws), so
        cache keys built from this reuse one program (and one captured
        graph) across any knob point.  A scenario keeps only
        ``ScenarioSpec.structural()`` (presence + period — the schedule
        knobs' shape); churn rates, cost tails, seeds and the competing
        policy are knob values."""
        return dataclasses.replace(cfg, ucb_c=0.0, budget=0.0,
                                   heterogeneity=1.0, seed=0,
                                   cost_noise=0.0, cost_model="fixed",
                                   async_alpha=0.5,
                                   policy=(cfg.policy
                                           if cfg.scenario is None
                                           else "ol4el"),
                                   scenario=(None if cfg.scenario is None
                                             else cfg.scenario.structural()))

    def _ingraph_cfg(self, caller: str,
                     mode: Optional[str] = None) -> OL4ELConfig:
        """The effective (mode-coerced, support-checked) fast-path config."""
        from repro_torch.el.ingraph import check_ingraph_support
        cfg = self.cfg
        if mode is not None and cfg.mode != mode:
            cfg = dataclasses.replace(cfg, mode=mode)
        # an injected ol4el Policy object carries its own exploration
        # constant; honor it like the host path does (other policy objects
        # are rejected by the support check below)
        if self._policy is not None and self._policy.name == "ol4el":
            cfg = dataclasses.replace(cfg, ucb_c=self._policy.ucb_c)
        check_ingraph_support(cfg, self._require_executor(), caller=caller)
        return cfg

    @property
    def compile_cache(self) -> ProgramCache:
        """The session's bounded compiled-program cache — pass it to a
        ``FleetServer(cache=...)`` to share one pool (and one hit/miss
        counter) between the server's cohorts and this session's
        verification runs."""
        return self._programs

    def clear_compile_cache(self) -> int:
        """Drop every cached program AND the last-used alias that keeps an
        evicted one alive.  Each program pins its device buffers (the
        padded per-edge datasets, the carry, a captured graph), so on a
        long-lived session this is what releases device memory.  Returns
        the number of cached programs dropped; the session stays usable —
        the next run rebuilds."""
        n = self._programs.clear()
        self._fastpath = None
        self._sweep_programs = []
        return n

    def close(self) -> None:
        """Release everything the session pins on the device: the compiled
        programs plus the initial-params reference.  After ``close()`` the
        session refuses to run — build a fresh one instead (idempotent)."""
        self.clear_compile_cache()
        self._init_params = None
        self._executor = None
        self._closed = True

    def _cache_program(self, key: tuple, program: Any) -> Any:
        """Insert into the bounded FIFO program cache (oldest evicted;
        the last-used alias keeps an evicted program alive until the next
        run replaces it)."""
        return self._programs.put(key, program)

    def run_sync_ingraph(self, max_rounds: int = DEFAULT_SYNC_HORIZON,
                         metric_fn: Optional[Callable] = None, *,
                         draws=None, mesh=None, donate: bool = False,
                         telemetry=None, profile: bool = False,
                         contract=None) -> ELReport:
        """Run the whole budgeted sync loop on the device.

        The supported matrix is ``repro_torch.el.ingraph``'s: policy ``ol4el``,
        cost model ``fixed`` or ``variable``, utility ``eval_gain`` (a device
        metric) or ``param_delta``, an ``InGraphExecutor`` such as
        ``ClassicExecutor``; an async config is coerced to sync.  With
        ``cfg.scenario`` set (a ``repro_torch.el.scenarios.ScenarioSpec``) it
        runs the scenario round — churn masks, straggler cost schedules, data
        drift — and ``cfg.policy`` may be a task-allocation baseline of its
        policy switch (``task_alloc``, ``delay_energy``).  Unsupported
        combinations raise an informative ``ValueError``/``TypeError``.
        Callbacks still fire, streamed after the device loop finishes.

        ``draws`` is the RNG-seam provider (``repro_torch.el.rng``);
        ``None`` draws from a ``torch.Generator`` on the program's device
        seeded with ``cfg.seed + 17`` (the reference's run key).  A
        ``ReplayDraws`` of the reference's ``jax.random`` draws reproduces
        its decisions.

        The program (its buffers and captured graph) is cached per
        structural config, so knob changes (ucb_c, budget, heterogeneity,
        cost noise, seed) reuse it.  ``report.telemetry`` holds the
        cache's counters and ``"device_loop"``: rounds, chunks (= host
        syncs), graphs captured and replays of this run.

        ``telemetry=`` switches the device rings on
        (``repro_torch.obs.rings.as_spec``: None/False off, True/int/
        ``TelemetrySpec`` on); they land in ``report.telemetry["rings"]``
        and the gate joins the program-cache key.  ``profile=True``
        attaches the program's :class:`repro_torch.obs.prof.
        ProgramProfile` (once per cached program) as
        ``report.telemetry["profile"]``; ``contract=`` also enforces a
        ``CollectiveContract`` before the run (``True``: the mode's
        ``default_contract``).  ``REPRO_EL_PROFILE=1`` /
        ``REPRO_EL_CONTRACTS=1`` arm these process-wide.

        ``mesh=`` (a ``repro_torch.launch.mesh.Mesh``) runs the program
        over the mesh's ranks, every rank calling this with the same
        session: the per-edge datasets and local blocks split over the
        edge axes, the edge stack all-gathered before the aggregation
        (``repro_torch.el.ingraph``).  Every rank returns the same report,
        bit for bit the unsharded run's.  On NCCL ranks (one a card) its
        chunks are CUDA graphs holding their gathers, captured and
        replayed as an unsharded run's; over gloo they run eagerly
        (``telemetry["device_loop"]["graphs_captured"] == 0``).
        ``donate=True`` makes the init params' tensors the run's parameter
        storage, with no copy: the run updates them in place and
        ``final_params`` shares their storage, so the session refuses to
        run from them again (pass fresh ``init_params``).  The program
        cache key holds the mesh and ``donate``, as the reference's.
        """
        from repro_torch.el.ingraph import make_sync_program, sync_knobs
        from repro_torch.el.rng import TorchDraws
        from repro_torch.obs import rings as obs_rings
        from repro_torch.obs import trace
        ex = self._require_executor()
        cfg = self._ingraph_cfg("run_sync_ingraph", mode="sync")
        spec = obs_rings.as_spec(telemetry)
        t0 = time.perf_counter()
        key = ("sync", ex, self._structural_cfg(cfg), max_rounds,
               metric_fn, self.metric_name,
               None if self._n_samples is None else tuple(self._n_samples),
               spec, mesh, bool(donate))
        params = self._initial_params()
        program = self._programs.get(key)
        if program is None:
            with trace.span("session.compile", mode="sync",
                            telemetry=spec is not None):
                program = make_sync_program(
                    ex.model, ex.edge_data, ex.eval_set, cfg, lr=ex.lr,
                    batch=ex.batch, n_samples=self._n_samples,
                    metric_fn=metric_fn, metric_name=self.metric_name,
                    max_rounds=max_rounds, mesh=mesh, telemetry=spec,
                    device=getattr(ex, "device", None))
                self._cache_program(key, program)
        self._fastpath = program
        self._profile_program(key, program, (params, sync_knobs(cfg)),
                              mode="sync", profile=profile,
                              contract=contract,
                              scenario=cfg.scenario is not None, mesh=mesh,
                              donate=donate)
        if draws is None:
            draws = TorchDraws(torch.Generator(device=program.device)
                               .manual_seed(cfg.seed + 17))
        with trace.span("session.dispatch", mode="sync") as sp:
            params, out = program(params, sync_knobs(cfg), draws,
                                  donate=donate)
            sp["n_rounds"] = int(out["n_rounds"])
        if donate:
            self._mark_donated()
        records: List[RoundRecord] = []
        for rec in records_from_out(out, 0, int(out["n_rounds"])):
            self._emit(records, rec)
        final = ex.evaluate(params)[self.metric_name]
        report = report_from_out(
            out, mode="sync", policy=cfg.policy, horizon=max_rounds,
            final_metric=final, final_params=params,
            elapsed_s=time.perf_counter() - t0, records=records)
        self._attach_cache_stats(report, key)
        report.telemetry["device_loop"] = dict(program.last_run)
        report.raw = out
        return report

    def run_async_ingraph(self, max_events: Optional[int] = None,
                          metric_fn: Optional[Callable] = None, *,
                          draws=None, mesh=None, donate: bool = False,
                          telemetry=None, profile: bool = False,
                          contract=None) -> ELReport:
        """Run the whole budgeted async event loop on the device
        (``repro_torch.el.events``): no host priority queue; finish times
        live in an ``[E]`` tensor, each step pops the earliest completion
        (or a K-event wave), staleness-merges that edge's block and
        schedules its next one, in chunks of masked steps replayed as CUDA
        graphs on a card.

        Same supported matrix as ``run_sync_ingraph`` (policy ``ol4el``, one
        bandit per edge); with ``cfg.scenario`` set it runs the single-event
        scenario body (dropout probes, straggler-scaled blocks, drift), so
        ``cfg.async_batch_k`` must be 0 or 1. ``max_events=None`` derives the
        event horizon from budget and cost, so runs end on budget exhaustion,
        never on silent truncation; the history is that horizon padded to a
        power of two (``padded_event_horizon``).  An explicit ``max_events`` is
        bucketed the same way (``bucket_event_horizon``) and the exact cap
        rides in as the ``event_cap`` knob, so nearby caps share one program.
        ``cfg.async_batch_k`` sets the K-event wave width (0: 1,
        ``resolve_async_batch_k``); it is structural, so it joins the
        program-cache key.

        ``draws`` is the RNG-seam provider (``None``: a
        ``torch.Generator`` on the program's device seeded with ``cfg.seed
        + 17``).  At fixed cost the result is bit-identical to the host
        twin on the same draws, ``run_async(rng_streams="jax")``.
        ``report.telemetry`` holds the cache's counters and
        ``"device_loop"`` (chunks, graphs, replays, ``batch_k``).

        ``telemetry=``, ``profile=`` and ``contract=`` work as in
        ``run_sync_ingraph``; the async rings record the event edge, the
        merge's alpha and staleness and the inter-arrival time too, and
        a wave wider than the ring raises.

        ``mesh=`` and ``donate=`` work as in ``run_sync_ingraph``: every
        rank calls this with the same session; the per-edge datasets and
        the fetched-params stack split over the mesh's edge axes, each
        event's (or wave's) blocks run on their edges' owners and are
        all-gathered (``repro_torch.el.events.program``), and every rank
        returns the same report, bit for bit the unsharded run's, its
        chunks captured on NCCL and eager over gloo.  On a mesh of more
        than one device ``async_batch_k = 0`` resolves to waves of
        ``min(4, n_edges)`` (``resolve_async_batch_k(cfg, mesh)``).
        ``donate=True`` makes the init params' tensors the global model's
        storage, with no copy, and the session refuses to run from them
        again.  The program cache key holds the mesh and ``donate``.
        """
        from repro_torch.el.events import (async_knobs, bucket_event_horizon,
                                           make_async_program,
                                           padded_event_horizon,
                                           resolve_async_batch_k)
        from repro_torch.el.rng import TorchDraws
        from repro_torch.obs import rings as obs_rings
        from repro_torch.obs import trace
        ex = self._require_executor()
        cfg = self._ingraph_cfg("run_async_ingraph", mode="async")
        spec = obs_rings.as_spec(telemetry)
        t0 = time.perf_counter()
        if max_events is None:
            horizon, event_cap = padded_event_horizon(cfg), None
        else:
            event_cap = int(max_events)
            horizon = bucket_event_horizon(event_cap)
        batch_k = resolve_async_batch_k(cfg, mesh)
        key = ("async", ex, self._structural_cfg(cfg), horizon, batch_k,
               metric_fn, self.metric_name, spec, mesh, bool(donate))
        params = self._initial_params()
        program = self._programs.get(key)
        if program is None:
            with trace.span("session.compile", mode="async",
                            telemetry=spec is not None):
                program = make_async_program(
                    ex.model, ex.edge_data, ex.eval_set, cfg, lr=ex.lr,
                    batch=ex.batch, metric_fn=metric_fn,
                    metric_name=self.metric_name, max_events=horizon,
                    mesh=mesh, telemetry=spec, batch_k=batch_k,
                    device=getattr(ex, "device", None))
                self._cache_program(key, program)
        self._fastpath = program
        knobs = async_knobs(cfg)
        if event_cap is not None:
            knobs["event_cap"] = np.int32(event_cap)
        self._profile_program(key, program, (params, knobs), mode="async",
                              profile=profile, contract=contract,
                              scenario=cfg.scenario is not None, mesh=mesh,
                              donate=donate)
        if draws is None:
            draws = TorchDraws(torch.Generator(device=program.device)
                               .manual_seed(cfg.seed + 17))
        with trace.span("session.dispatch", mode="async") as sp:
            params, out = program(params, knobs, draws, donate=donate)
            sp["n_events"] = int(out["n_rounds"])
        if donate:
            self._mark_donated()
        records: List[RoundRecord] = []
        for rec in records_from_out(out, 0, int(out["n_rounds"])):
            self._emit(records, rec)
        final = ex.evaluate(params)[self.metric_name]
        report = report_from_out(
            out, mode="async", policy=cfg.policy,
            horizon=horizon if event_cap is None else event_cap,
            final_metric=final, final_params=params,
            elapsed_s=time.perf_counter() - t0, records=records)
        self._attach_cache_stats(report, key)
        report.telemetry["device_loop"] = dict(program.last_run,
                                               batch_k=batch_k)
        report.raw = out
        return report

    # -- ablation sweeps -----------------------------------------------------

    def sweep(self, spec, *, draws=None, mesh=None,
              metric_fn: Optional[Callable] = None, telemetry=None):
        """Run a whole ablation grid as one device loop.

        ``spec`` is a :class:`repro_torch.el.sweep.SweepSpec` — grids over
        ``ucb_c`` / ``budget`` / ``heterogeneity`` / ``cost_noise`` /
        ``async_alpha`` / ``async_batch_k`` / ``seeds``, and with
        ``cfg.scenario`` set the scenario engine's ``policy`` (sync) and
        ``churn_rate`` axes; empty axes inherit this session's config. The
        session's ``cfg.mode`` picks the program the cells run: the sync round
        (``repro_torch.el.ingraph``) or the async event engine
        (``repro_torch.el.events``), with a leading cell dimension (the masked
        step vmapped over the cells, one CUDA graph replay a chunk on a card).
        Every cell makes the decisions of an independent ``run_sync_ingraph`` /
        ``run_async_ingraph`` with that cell's config on the same draws, and
        the same support matrix applies.  Each ``async_batch_k`` value is a
        different wave body, so an async grid runs one sub-sweep per K (the
        axis is slowest-varying: the sub-results concatenate back into
        ``spec.cells()`` order).

        ``draws`` is ``None`` (each cell draws from a ``torch.Generator``
        on the program's device seeded with its ``seed + 17``, the stream
        its solo run draws) or one RNG-seam provider per cell in
        ``spec.cells()`` order.  Programs are cached per (structural
        config, grid shape, ``max_rounds``), so a rerun with new knob
        values reuses the captured graph.  A workload without a device
        metric (K-means F1) has its cells' final params scored here.
        ``telemetry=`` switches the per-cell rings on (see
        ``run_sync_ingraph``); each cell's rings land stacked in the
        report's ``out["telemetry"]`` leaves.

        ``mesh=`` runs the grid over the mesh's ranks, every rank calling
        this with the same session: each (sub-)grid's cells split over the
        edge axes (``repro_torch.el.sweep.sweep_partition_specs``; a grid
        that does not tile them raises ``ValueError``), each rank runs its
        cells with their draw providers, and the cells are all-gathered,
        so every rank returns the same cells, ``out`` and final params,
        bit for bit the unsharded sweep's.  ``telemetry["device_loops"]``
        is this rank's runners'.  The mesh joins the program key.  Returns
        a
        :class:`repro_torch.el.sweep.SweepReport`.
        """
        from repro_torch.el.sweep.engine import (make_sweep_program,
                                                 run_sweep_program)
        from repro_torch.el.sweep.report import SweepReport
        from repro_torch.interop import tree_map
        from repro_torch.obs import rings as obs_rings
        from repro_torch.obs import trace
        ex = self._require_executor()
        cfg = self._ingraph_cfg("ELSession.sweep")
        tele_spec = obs_rings.as_spec(telemetry)
        if draws is not None and len(draws) != spec.n_cells:
            raise ValueError(f"ELSession.sweep: {len(draws)} draw providers "
                             f"for {spec.n_cells} cells")
        t0 = time.perf_counter()
        subs = (spec.per_batch_k() if cfg.mode == "async"
                else [(None, spec)])
        params_parts, out_parts, loops, first = [], [], [], 0
        self._sweep_programs = []
        for k_val, sub in subs:
            sub_cfg = (cfg if k_val is None else dataclasses.replace(
                cfg, async_batch_k=int(k_val)))
            # the program depends on the structural config (wave width
            # included), the grid's shape and max_rounds, not the knobs
            spec_shape = (tuple(len(v) for v in sub.axes(sub_cfg).values()),
                          sub.max_rounds)
            key = ("sweep", ex, self._structural_cfg(sub_cfg), spec_shape,
                   metric_fn, self.metric_name,
                   None if self._n_samples is None
                   else tuple(self._n_samples), tele_spec, mesh)
            program = self._programs.get(key)
            if program is None:
                with trace.span("session.compile", mode="sweep",
                                n_cells=sub.n_cells):
                    program = make_sweep_program(
                        ex.model, ex.edge_data, ex.eval_set, sub_cfg, sub,
                        lr=ex.lr, batch=ex.batch,
                        n_samples=self._n_samples, metric_fn=metric_fn,
                        metric_name=self.metric_name, mesh=mesh,
                        telemetry=tele_spec,
                        device=getattr(ex, "device", None))
                    self._cache_program(key, program)
            self._sweep_programs.append(program)
            sub_draws = (None if draws is None
                         else list(draws[first:first + sub.n_cells]))
            first += sub.n_cells
            with trace.span("session.dispatch", mode="sweep",
                            n_cells=sub.n_cells):
                params, out = run_sweep_program(
                    program, self._initial_params(),
                    sub.cell_cfgs(sub_cfg), sub_draws, mesh=mesh)
            params_parts.append(params)
            out_parts.append(out)
            loops.append(dict(program.last_run))
        # async_batch_k is slowest-varying, so concatenating the sub-sweeps
        # along the cell axis reproduces spec.cells()
        params = tree_map(lambda *xs: torch.cat(xs), *params_parts)
        out = tree_map(lambda *xs: np.concatenate(xs), *out_parts)
        report = SweepReport(
            spec=spec, axes=spec.axes(cfg), cells=spec.cells(cfg),
            out=out, policy=cfg.policy,
            elapsed_s=time.perf_counter() - t0, final_params=params,
            telemetry={"cache": self._programs.stats(),
                       "device_loops": loops})
        # workloads without a device metric (K-means F1) run the program
        # with a NaN metric history; score the final params host-side so
        # the report's frontier still has an accuracy axis
        report.score_final_params(
            lambda p: ex.evaluate(p)[self.metric_name])
        return report

    # -- AC-sync estimator plumbing ------------------------------------------

    @staticmethod
    def _update_ac(coord: CloudCoordinator, edge_params: List[Params],
                   prev_global: Params, new_global: Params,
                   tau: int) -> None:
        local_deltas = np.array([param_l2_delta(prev_global, p)
                                 for p in edge_params])
        global_delta = param_l2_delta(prev_global, new_global)
        coord.ac.update_estimates(local_deltas, global_delta, tau)

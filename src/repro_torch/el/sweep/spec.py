"""``SweepSpec`` — a declarative ablation grid over the EL control plane.

A copy of the reference's ``repro.el.sweep.spec`` on the port's
``OL4ELConfig``.

The paper's headline results are exactly these grids: policy
hyperparameters × budgets × heterogeneity, repeated over seeds (Figs.
3–5).  A ``SweepSpec`` names the axes; the engine flattens them
row-major into ``[n_cells]`` (seed fastest, so seed-replicates of one
hyperparameter point are contiguous) and runs every cell inside one
device loop with a leading cell dimension.

Only knobs that enter the compiled programs as *inputs* are sweepable
(``repro_torch.el.ingraph.KNOB_NAMES`` /
``repro_torch.el.events.ASYNC_KNOB_NAMES`` territory): the ``ol4el``
exploration constant ``ucb_c``, the per-edge ``budget``, the fleet
``heterogeneity`` (it only moves the cost arrays), the variable-cost
noise scale ``cost_noise``, the async staleness-mix base rate
``async_alpha`` (a no-op axis for sync grids), and the bandit/data
``seed``.  Structural knobs (n_edges, max_interval, utility, policy,
mode) change the program itself and stay fixed across a sweep — run
several sweeps to compare those (the session's ``cfg.mode`` picks the
sync round vs the async event-horizon program for the whole grid).

``async_batch_k`` is the one *semi-structural* axis: each K value is a
different step body (the K-event wave width), so the session splits
the grid into one sub-sweep per K — the axis is SLOWEST-varying
(first in ``AXIS_ORDER``) so each sub-sweep's cells are one contiguous
block of the flattened grid, and the concatenated results line up with
``cells()`` exactly.  All K values compute identical results (the
wave program is order-equivalent to K=1); sweeping it compares
*throughput*, not learning curves.

The ``policy`` and ``churn_rate`` axes sweep the scenario engine's
knobs (``repro_torch.el.scenarios``): the policy competes through the
``policy_id`` switch and the churn rate only re-draws the ``scn_active``
schedule, so both are plain knob-value axes and every cell shares one
program.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Sequence, Tuple

from repro_torch.config import OL4ELConfig

#: Sweep-axis order; the flattened cell index is row-major over these,
#: so ``seed`` varies fastest and ``async_batch_k`` slowest (each K is
#: its own sub-sweep; first place keeps its cells contiguous).
#: ``policy`` and ``churn_rate`` are scenario-engine axes: the policy
#: competes through the ``policy_id`` switch and the churn rate only
#: re-draws the ``scn_active`` schedule, so BOTH are plain knob-value
#: axes — every cell still shares one program.
AXIS_ORDER = ("async_batch_k", "policy", "ucb_c", "budget",
              "heterogeneity", "cost_noise", "async_alpha",
              "churn_rate", "seed")


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """Grids over the sweepable control-plane knobs.

    An empty axis (the default) means "inherit the session config's
    value" — a one-point axis.  ``seeds`` must name at least one seed.

    Seed semantics: a sweep seed varies the *in-program* random streams
    (bandit selection, minibatch sampling, cost noise) — the dataset,
    edge partition and init params are program constants shared by every
    cell.  To resample those too, run one sweep per data seed.

    ``max_rounds`` bounds the per-cell history length: sync rounds for
    sync grids, merge *events* for async grids (where a generous bound
    is ``repro_torch.el.events.padded_event_horizon``).
    """

    ucb_c: Tuple[float, ...] = ()
    budget: Tuple[float, ...] = ()
    heterogeneity: Tuple[float, ...] = ()
    cost_noise: Tuple[float, ...] = ()
    async_alpha: Tuple[float, ...] = ()
    async_batch_k: Tuple[int, ...] = ()
    #: competitor-policy axis (``repro_torch.el.scenarios.
    #: INGRAPH_POLICY_ORDER`` names) — through the ``policy_id`` switch,
    #: so a multi-policy grid is still ONE program; needs ``cfg.scenario``
    #: set (sync mode)
    policy: Tuple[str, ...] = ()
    #: churn-rate axis — re-draws each cell's ``scn_active`` schedule;
    #: needs a churn-bearing ``cfg.scenario``
    churn_rate: Tuple[float, ...] = ()
    seeds: Tuple[int, ...] = (0,)
    max_rounds: int = 256

    def __post_init__(self):
        for name in ("ucb_c", "budget", "heterogeneity", "cost_noise",
                     "async_alpha", "async_batch_k", "policy",
                     "churn_rate", "seeds"):
            vals = getattr(self, name)
            if not isinstance(vals, tuple):
                object.__setattr__(self, name, tuple(vals))
        if not self.seeds:
            raise ValueError("SweepSpec.seeds must name at least one seed")
        if self.max_rounds <= 0:
            raise ValueError(
                f"SweepSpec.max_rounds must be positive, got "
                f"{self.max_rounds}")
        if any(b <= 0 for b in self.budget):
            raise ValueError(f"SweepSpec.budget values must be positive, "
                             f"got {self.budget}")
        if any(h < 1.0 for h in self.heterogeneity):
            raise ValueError("SweepSpec.heterogeneity values are "
                             "fastest/slowest ratios and must be >= 1, "
                             f"got {self.heterogeneity}")
        if any(n < 0 for n in self.cost_noise):
            raise ValueError("SweepSpec.cost_noise values are relative "
                             "noise scales and must be >= 0, got "
                             f"{self.cost_noise}")
        if any(not 0.0 < a <= 1.0 for a in self.async_alpha):
            raise ValueError("SweepSpec.async_alpha values are mixing "
                             "rates and must be in (0, 1], got "
                             f"{self.async_alpha}")
        if any(int(k) < 0 for k in self.async_batch_k):
            raise ValueError("SweepSpec.async_batch_k values are wave "
                             "widths and must be >= 0 (0 = auto), got "
                             f"{self.async_batch_k}")
        if self.policy:
            from repro_torch.el.scenarios.baselines import \
                INGRAPH_POLICY_ORDER
            bad = tuple(p for p in self.policy
                        if p not in INGRAPH_POLICY_ORDER)
            if bad:
                raise ValueError(
                    f"SweepSpec.policy values must be in-graph switch "
                    f"policies {INGRAPH_POLICY_ORDER}, got {bad}")
        if any(not 0.0 <= r < 1.0 for r in self.churn_rate):
            raise ValueError("SweepSpec.churn_rate values are dropout "
                             "probabilities and must be in [0, 1), got "
                             f"{self.churn_rate}")

    # -- flattening ----------------------------------------------------------

    def axes(self, cfg: OL4ELConfig) -> Dict[str, Tuple]:
        """Axis name -> values, empty axes defaulted from ``cfg``."""
        scn = cfg.scenario
        base_rate = (scn.churn.rate
                     if scn is not None and scn.churn is not None
                     else 0.0)
        return {
            "async_batch_k": self.async_batch_k or (cfg.async_batch_k,),
            "policy": self.policy or (cfg.policy,),
            "ucb_c": self.ucb_c or (cfg.ucb_c,),
            "budget": self.budget or (cfg.budget,),
            "heterogeneity": self.heterogeneity or (cfg.heterogeneity,),
            "cost_noise": self.cost_noise or (cfg.cost_noise,),
            "async_alpha": self.async_alpha or (cfg.async_alpha,),
            "churn_rate": self.churn_rate or (base_rate,),
            "seed": self.seeds,
        }

    @property
    def n_cells(self) -> int:
        n = 1
        for vals in (self.async_batch_k or (None,),
                     self.policy or (None,),
                     self.ucb_c or (None,), self.budget or (None,),
                     self.heterogeneity or (None,),
                     self.cost_noise or (None,),
                     self.async_alpha or (None,),
                     self.churn_rate or (None,), self.seeds):
            n *= len(vals)
        return n

    def cells(self, cfg: OL4ELConfig) -> List[Dict[str, float]]:
        """The flattened ``[n_cells]`` grid, row-major (seed fastest)."""
        axes = self.axes(cfg)
        return [dict(zip(AXIS_ORDER, combo))
                for combo in itertools.product(*(axes[a]
                                                 for a in AXIS_ORDER))]

    def cell_cfgs(self, cfg: OL4ELConfig) -> List[OL4ELConfig]:
        """One per-cell config per flattened cell — exactly what an
        independent ``run_sync_ingraph`` / ``run_async_ingraph`` of that
        cell would use (the sweep-vs-independent equivalence tests lean
        on this).  The session config's ``mode`` carries through to every
        cell.  Only an EXPLICIT ``cost_noise`` axis flips nonzero-noise
        cells to ``cost_model="variable"`` (the knob derivations gate
        noise on it); an inherited one-point axis keeps the session's
        cost model, so a fixed-cost session with a dormant
        ``cfg.cost_noise`` sweeps exactly like its single runs.

        The scenario axes are likewise value-only: an explicit
        ``policy`` axis swaps each cell's ``cfg.policy`` (entering the
        program as the ``policy_id`` knob), and an explicit
        ``churn_rate`` axis rewrites ``cfg.scenario.churn.rate`` — the
        scenario's PERIOD (the only structural residue) is untouched, so
        every cell still shares one program.  Both explicit axes require
        a ``cfg.scenario``."""
        explicit_noise = bool(self.cost_noise)
        if (self.policy or self.churn_rate) and cfg.scenario is None:
            raise ValueError(
                "SweepSpec policy/churn_rate axes sweep the scenario "
                "engine's traced knobs and need cfg.scenario set (an "
                "identity ScenarioSpec() is enough for the policy axis)")
        if self.churn_rate and cfg.scenario.churn is None:
            raise ValueError(
                "SweepSpec.churn_rate re-draws the dropout schedule and "
                "needs cfg.scenario.churn set (e.g. ChurnSpec())")

        def _cell_scenario(c):
            if not self.churn_rate:
                return cfg.scenario
            return dataclasses.replace(
                cfg.scenario, churn=dataclasses.replace(
                    cfg.scenario.churn, rate=float(c["churn_rate"])))

        return [dataclasses.replace(
            cfg, ucb_c=float(c["ucb_c"]),
            budget=float(c["budget"]),
            heterogeneity=float(c["heterogeneity"]),
            cost_noise=float(c["cost_noise"]),
            cost_model=("variable"
                        if explicit_noise and c["cost_noise"] > 0
                        else cfg.cost_model),
            async_alpha=float(c["async_alpha"]),
            policy=str(c["policy"]),
            scenario=_cell_scenario(c),
            async_batch_k=int(c["async_batch_k"]), seed=int(c["seed"]))
            for c in self.cells(cfg)]

    def per_batch_k(self) -> List[Tuple[int, "SweepSpec"]]:
        """Split into one sub-spec per ``async_batch_k`` value (grid
        order).  Each K builds a different wave body, so the engine runs
        one program per sub-spec; the axis is slowest-varying, so
        concatenating the sub-results along the cell axis reproduces the
        full flattened grid."""
        ks = self.async_batch_k or (None,)
        if len(ks) <= 1:
            return [(ks[0], self)]
        return [(k, dataclasses.replace(self, async_batch_k=(k,)))
                for k in ks]

    def describe(self, cfg: OL4ELConfig) -> str:
        axes = self.axes(cfg)
        dims = " × ".join(f"{len(v)} {k}" for k, v in axes.items())
        return f"{self.n_cells} cells ({dims}), max_rounds={self.max_rounds}"


def spec_from_sequences(ucb_c: Sequence[float] = (),
                        budget: Sequence[float] = (),
                        heterogeneity: Sequence[float] = (),
                        cost_noise: Sequence[float] = (),
                        async_alpha: Sequence[float] = (),
                        async_batch_k: Sequence[int] = (),
                        policy: Sequence[str] = (),
                        churn_rate: Sequence[float] = (),
                        seeds: Sequence[int] = (0,),
                        max_rounds: int = 256) -> SweepSpec:
    """CLI-friendly constructor (lists in, validated tuples out)."""
    return SweepSpec(ucb_c=tuple(float(x) for x in ucb_c),
                     budget=tuple(float(x) for x in budget),
                     heterogeneity=tuple(float(x) for x in heterogeneity),
                     cost_noise=tuple(float(x) for x in cost_noise),
                     async_alpha=tuple(float(x) for x in async_alpha),
                     async_batch_k=tuple(int(k) for k in async_batch_k),
                     policy=tuple(str(p) for p in policy),
                     churn_rate=tuple(float(r) for r in churn_rate),
                     seeds=tuple(int(s) for s in seeds),
                     max_rounds=int(max_rounds))

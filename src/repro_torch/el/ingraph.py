"""The compiled sync EL round on the device: a whole budgeted run with no
host sync per round.

The reference stages the budgeted sync loop

    in-graph bandit select  (selection weights + Gumbel-max)
      → local iterations on every edge (``jax.vmap`` over edges)
      → weighted parameter aggregation
      → in-graph utility (eval-gain or param-delta)
      → bandit update + budget charge

into one ``lax.while_loop``.  Here the same round is torch ops on the
run's device: edges are a leading batch dimension of the params, the
batches and the K-means E-step (one launch of ``kmeans_assign``'s batched
entry per local step), and the ``while_loop`` becomes fixed chunks of R
masked rounds.  A round whose ``cond`` is false leaves every carry entry
bit-unchanged, so a chunk may run past the end of the run.  On a card
each chunk is captured once as a CUDA graph over static buffers (carry,
knobs, draws) and replayed; termination is read back once per chunk.  On
the CPU the same chunk runs eagerly.

The control-plane knobs (exploration constant, per-edge budget, cost
arrays) are inputs, not constants: ``sync_knobs(cfg)`` derives them on
the host and a program refills its knob buffers per run, so one captured
graph serves any knob point.  Every random draw comes through the RNG
seam (``repro_torch.el.rng``): the chunk's Gumbel vectors, minibatch
uniforms and cost-noise normals are written into static buffers before
each replay, so the graph holds no RNG op.

The f32 arithmetic is the reference's, op for op, where a decision can
hang on it: XLA contracts ``interval * comp + comm``, ``1 + noise * eps``
and the aggregation's sum over edges into fused multiply-adds, which the
port rounds the same way (products and sums in f64, one rounding to
f32); the ``floor(residual / cost)`` frequencies, the ``1e-12`` / ``1e-9``
guards and ``idx = trunc(u * f32(n_e))`` are f32 as there.

Supported configuration matrix (``check_ingraph_support``):

  ==============  =======================================================
  mode             ``sync`` (this module) and ``async`` (the event engine,
                   ``repro_torch.el.events``)
  policy           ``ol4el`` (the 3-step KUBE bandit, one shared bandit)
  cost_model       ``fixed`` and ``variable`` (the ``cost_noise`` knob;
                   0 multiplies by exactly 1.0)
  scenario         ``None`` only (scenarios: ROADMAP Queue 1 item 10)
  utility          ``eval_gain`` (needs a device metric) and
                   ``param_delta``
  executor         ``InGraphExecutor`` shape — raw per-edge arrays + a
                   model whose ``step`` takes a leading edge dimension
                   (``ClassicExecutor``)
  ==============  =======================================================

``mesh=`` (ROADMAP Queue 1 item 14) and ``telemetry=`` (item 12) raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import OL4ELConfig
from repro_torch.core.bandit import (device_arm_logits, device_bandit_init,
                                     device_bandit_update,
                                     device_selection_weights)
from repro_torch.core.coordinator import edge_speed_factors
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.interop import tree_leaves, tree_map
from repro_torch.models.classic import accuracy_tensor, correct_count

Params = Any
Carry = Dict[str, Any]
Knobs = Dict[str, torch.Tensor]

#: Names of the per-run control-plane inputs: scalars ``ucb_c`` /
#: ``budget`` / ``cost_noise``, per-edge ``comp`` / ``comm`` /
#: ``min_edge_cost`` ``[E]``, and the binding-edge arm costs ``costs_k``
#: ``[K]``.
KNOB_NAMES = ("ucb_c", "budget", "comp", "comm", "costs_k", "min_edge_cost",
              "cost_noise")

_INGRAPH_UTILITIES = ("eval_gain", "param_delta")
_INGRAPH_COST_MODELS = ("fixed", "variable")

#: Attributes an executor must expose to be in-graph capable
#: (the ``InGraphExecutor`` Protocol, satisfied by ``ClassicExecutor``).
INGRAPH_EXECUTOR_ATTRS = ("model", "edge_data", "eval_set", "batch", "lr")

_SCENARIO_ITEM = ("scenarios (ScenarioSpec) arrive with ROADMAP Queue 1 "
                  "item 10")


def _combo(cfg: OL4ELConfig, executor: Any) -> str:
    ex_name = type(executor).__name__ if executor is not None else "<unset>"
    scn = "None" if cfg.scenario is None else type(cfg.scenario).__name__
    return (f"(policy={cfg.policy!r}, cost_model={cfg.cost_model!r}, "
            f"scenario={scn}, executor={ex_name})")


def support_matrix() -> str:
    """The supported configuration matrix, rendered for error messages —
    so an unsupported combination is rejected at the front door with the
    full menu."""
    return (
        "supported in-graph matrix:\n"
        "  mode        'sync' (repro_torch.el.ingraph) and 'async' "
        "(repro_torch.el.events)\n"
        "  policy      'ol4el' (other registry policies run host-side "
        "only; the scenario policy switch is ROADMAP Queue 1 item 10)\n"
        f"  cost_model  cfg.cost_model in {_INGRAPH_COST_MODELS}; "
        "heavy-tailed / replayed models are ScenarioSpec cost kinds "
        "(ROADMAP Queue 1 item 10)\n"
        "  scenario    None\n"
        f"  utility     {_INGRAPH_UTILITIES}\n"
        "  executor    InGraphExecutor shape (raw per-edge arrays + a "
        "model whose step takes a leading edge dimension, e.g. "
        "ClassicExecutor)")


def check_ingraph_support(cfg: OL4ELConfig, executor: Any = None, *,
                          caller: str = "the in-graph fast path") -> None:
    """Validate a config/executor combination against the supported matrix.

    Raises ``ValueError`` naming the unsupported (policy, cost_model,
    scenario, executor) combination with the full :func:`support_matrix`,
    ``TypeError`` when the executor is not in-graph capable, and
    ``NotImplementedError`` for a scenario (a later slice).
    """
    from repro_torch.el import policies as el_policies
    if cfg.mode not in ("sync", "async"):
        raise ValueError(
            f"{caller} does not support mode={cfg.mode!r}; in-graph modes "
            "are 'sync' and 'async'\n" + support_matrix())
    if cfg.scenario is not None:
        raise NotImplementedError(f"{caller}: {_SCENARIO_ITEM}")
    if cfg.mode not in el_policies.ingraph_modes(cfg.policy):
        raise ValueError(
            f"{caller} does not support {_combo(cfg, executor)} in "
            f"mode={cfg.mode!r}: the compiled programs implement the "
            "'ol4el' selection rule; run other policies through the host "
            "paths ELSession.run_sync()/run_async()\n" + support_matrix())
    if cfg.policy != "ol4el":
        raise ValueError(
            f"{caller} does not support {_combo(cfg, executor)}: policy "
            f"{cfg.policy!r} compiles only through the scenario policy "
            "switch (ROADMAP Queue 1 item 10)\n" + support_matrix())
    if cfg.cost_model not in _INGRAPH_COST_MODELS:
        hint = ""
        if cfg.cost_model in ("pareto", "lognormal") or str(
                cfg.cost_model).startswith("trace"):
            hint = (f" — {cfg.cost_model!r} is a ScenarioSpec cost KIND, "
                    "not a cfg.cost_model (ROADMAP Queue 1 item 10)")
        raise ValueError(
            f"{caller} does not support {_combo(cfg, executor)}: "
            f"cost_model must be one of {_INGRAPH_COST_MODELS}{hint}\n"
            + support_matrix())
    if cfg.utility not in _INGRAPH_UTILITIES:
        raise ValueError(
            f"{caller} does not support utility={cfg.utility!r} with "
            f"{_combo(cfg, executor)}: in-graph utilities are "
            f"{_INGRAPH_UTILITIES}\n" + support_matrix())
    if executor is not None:
        missing = [a for a in INGRAPH_EXECUTOR_ATTRS
                   if not hasattr(executor, a)]
        if missing:
            raise TypeError(
                f"{type(executor).__name__} is not in-graph capable "
                f"(missing .{missing[0]}); {caller} with "
                f"{_combo(cfg, executor)} needs an InGraphExecutor such "
                "as ClassicExecutor (raw per-edge arrays + a model whose "
                "step takes a leading edge dimension)")


def base_cost_knobs(cfg: OL4ELConfig) -> Dict[str, np.ndarray]:
    """The mode-independent control-plane knobs: scalars ``ucb_c`` /
    ``budget`` / ``cost_noise`` and the per-edge cost arrays, in the
    reference's f32 numpy arithmetic."""
    speed = edge_speed_factors(cfg.n_edges, cfg.heterogeneity)
    comp = np.asarray(cfg.comp_cost * speed, np.float32)            # [E]
    comm = np.full((cfg.n_edges,), cfg.comm_cost, np.float32)       # [E]
    return {
        "ucb_c": np.float32(cfg.ucb_c),
        "budget": np.float32(cfg.budget),
        "comp": comp,
        "comm": comm,
        "min_edge_cost": comp + comm,                               # [E]
        # noise applies only in variable-cost mode; a 0.0 knob multiplies
        # costs by exactly 1.0, bit-for-bit fixed
        "cost_noise": np.float32(cfg.cost_noise
                                 if cfg.cost_model == "variable" else 0.0),
    }


def sync_knobs(cfg: OL4ELConfig) -> Dict[str, np.ndarray]:
    """Host-side control-plane inputs of the compiled sync program, all
    f32; feasibility is scored against the binding (slowest) edge."""
    if cfg.scenario is not None:
        raise NotImplementedError(f"sync_knobs: {_SCENARIO_ITEM}")
    knobs = base_cost_knobs(cfg)
    intervals_f = np.arange(1, cfg.max_interval + 1, dtype=np.float32)
    worst = int(np.argmax(knobs["comp"]))
    knobs["costs_k"] = (intervals_f * knobs["comp"][worst]
                        + knobs["comm"][worst])                     # [K]
    return knobs


def sync_knob_names(cfg: OL4ELConfig) -> Tuple[str, ...]:
    """The input names of this config's compiled sync program (exactly
    the keys ``sync_knobs(cfg)`` returns)."""
    if cfg.scenario is not None:
        raise NotImplementedError(f"sync_knob_names: {_SCENARIO_ITEM}")
    return KNOB_NAMES


def _pad_edge_data(edge_data: List[Dict[str, np.ndarray]],
                   device: DeviceLike
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stack per-edge datasets [E, Nmax, d] / [E, Nmax] with wraparound
    padding (padding rows repeat real rows, so uniform index sampling over
    [0, n_e) never sees them), on ``device``."""
    n = np.array([len(d["y"]) for d in edge_data], np.int32)
    n_max = int(n.max())
    dim = np.asarray(edge_data[0]["x"]).shape[-1]
    xs = np.zeros((len(edge_data), n_max, dim), np.float32)
    ys = np.zeros((len(edge_data), n_max), np.int64)
    for e, d in enumerate(edge_data):
        reps = -(-n_max // len(d["y"]))
        xs[e] = np.tile(np.asarray(d["x"], np.float32), (reps, 1))[:n_max]
        ys[e] = np.tile(np.asarray(d["y"], np.int64), reps)[:n_max]
    dev = torch.device(device)
    return (torch.as_tensor(xs, device=dev), torch.as_tensor(ys, device=dev),
            torch.as_tensor(n, device=dev))


def default_metric_fn(model, eval_set, metric_name: str
                      ) -> Optional[Callable[[Params], torch.Tensor]]:
    """A device metric when the model supports one (SVM accuracy, an f32
    0-dim tensor through the pinned ``accuracy_tensor``); None means the
    in-graph path must run with a params-only utility."""
    if metric_name == "accuracy" and hasattr(model, "scores"):
        dev = getattr(model, "device", None)
        xe = torch.as_tensor(eval_set["x"], dtype=torch.float32, device=dev)
        ye = torch.as_tensor(eval_set["y"], device=dev).long()
        scale = float(np.float32(1) / np.float32(ye.shape[-1]))

        def accuracy(params: Params) -> torch.Tensor:
            return accuracy_tensor(model.scores(params, xe), ye)

        def with_gain(params: Params, prev_metric: torch.Tensor):
            """(accuracy, accuracy - prev_metric) as XLA computes them in
            one expression: the mean's multiply fused into the
            subtraction, one rounding."""
            count = correct_count(model.scores(params, xe), ye)
            return count * scale, _fma32(count, scale, -prev_metric)

        accuracy.with_gain = with_gain
        return accuracy
    return None


def _fma32(a, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once, as a fused multiply-add rounds it
    (XLA contracts these): the f32 product is exact in f64, and one
    rounding of the f64 sum to f32 is the fused result (a double rounding
    needs an f64 sum on an f32 midpoint)."""
    def f64(v):
        return v.double() if isinstance(v, torch.Tensor) else float(v)
    return (f64(a) * f64(b) + f64(c)).float()


def _edge_sum(v: torch.Tensor) -> torch.Tensor:
    """Σ_e v[e] in f32, edge by edge in order, as XLA sums a short
    vector."""
    total = v[0]
    for e in range(1, v.shape[0]):
        total = total + v[e]
    return total


def _tree_l2(a: Params, b: Params) -> torch.Tensor:
    total = None
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        s = ((x.float() - y.float()) ** 2).sum()
        total = s if total is None else total + s
    return torch.sqrt(total)


def make_local_block(model, xs: torch.Tensor, ys: torch.Tensor,
                     n_per_edge: torch.Tensor, batch: int, lr: float,
                     k: int) -> Callable:
    """``local_block(params, interval, uniform, lanes=None)`` —
    ``interval`` masked local iterations on L lanes at once, lane l on
    edge ``lanes[l]`` (default: every edge, lane e on edge e): ``params``
    is the per-lane stack ``[L, ...]``, ``interval`` a scalar or one per
    lane ``[L]``, ``uniform`` the lanes' minibatch uniforms ``[L, k,
    batch]``.  Always ``k`` steps, steps past a lane's interval masked, as
    the reference's fixed-length ``lax.scan``; every step is one batched
    model step over the lanes (one launch of ``kmeans_assign``'s batched
    entry for K-means).  A step's indices are ``trunc(u * f32(n_e))``
    (clamped to the padded length, as ``jnp`` indexing clamps), so a
    replayed uniform picks the reference's rows."""
    n_max = xs.shape[1]
    all_edges = torch.arange(xs.shape[0], device=xs.device)
    n_f = n_per_edge.float()

    def local_block(params: Params, interval: torch.Tensor,
                    uniform: torch.Tensor,
                    lanes: Optional[torch.Tensor] = None) -> Params:
        if lanes is None:
            lanes = all_edges
        rows, n_l = lanes[:, None], n_f[lanes][:, None]          # [L, 1]
        for step in range(k):
            idx = (uniform[:, step] * n_l).long().clamp_(max=n_max - 1)
            b = {"x": xs[rows, idx], "y": ys[rows, idx]}         # [L, B, ...]
            p2 = model.step(params, b, lr)
            take = (step < interval).reshape(-1)                 # [L] or [1]
            params = tree_map(lambda a, c: torch.where(
                take.reshape((-1,) + (1,) * (a.dim() - 1)), c, a),
                params, p2)
        return params

    return local_block


@dataclasses.dataclass(frozen=True)
class ELCell:
    """One EL run's loop, split into composable pieces.

    The closures share the program's dict carry (``carry["t"]`` is the
    round or event counter, ``carry["hist"]`` the ``[horizon]`` history
    arrays) and all take the knob dict explicitly.  ``body`` also takes
    its draws: the sync round its own (``gumbel`` [K], ``uniform`` [E, k,
    batch], ``normal`` [E]), the async step a chunk's (see
    ``repro_torch.el.events.program``); ``draw_shapes`` names the shape
    of one item and ``items_per_step`` how many items a step may take
    (a sync round 1, an async wave ``batch_k``).  ``init`` takes the
    initial draws, shaped ``init_draw_shapes`` (none for sync).  A
    ``ChunkRunner`` fuses ``init → chunks of masked body → finalize``.
    """

    init: Callable       # (init_params, knobs, init_draws) -> carry
    cond: Callable       # (carry, knobs) -> bool tensor (continue?)
    body: Callable       # (carry, knobs, draws) -> carry (one round)
    finalize: Callable   # (carry, knobs) -> (params, out dict)
    horizon: int         # history length (max_rounds / max_events)
    draw_shapes: Dict[str, Tuple[int, ...]]
    device: torch.device
    init_draw_shapes: Dict[str, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict)
    items_per_step: int = 1


def make_sync_cell(model, edge_data, eval_set, cfg: OL4ELConfig, *,
                   lr: float, batch: int,
                   n_samples: Optional[np.ndarray] = None,
                   metric_fn: Optional[Callable] = None,
                   metric_name: str = "accuracy",
                   max_rounds: int = 512, mesh=None, telemetry=None,
                   device: DeviceLike = None) -> ELCell:
    """The budgeted sync round as an :class:`ELCell` on ``device``
    (default: the model's)."""
    if mesh is not None:
        raise NotImplementedError(
            "make_sync_cell(mesh=...): sharded runs arrive with ROADMAP "
            "Queue 1 item 14")
    if telemetry not in (None, False):
        raise NotImplementedError(
            "make_sync_cell(telemetry=...): the device rings arrive with "
            "ROADMAP Queue 1 item 12")
    check_ingraph_support(cfg, caller="make_sync_program")
    dev = resolve_device(device if device is not None
                         else getattr(model, "device", None))
    n_edges, k = cfg.n_edges, cfg.max_interval
    if len(edge_data) != n_edges:
        raise ValueError(f"cfg.n_edges = {n_edges} but the executor has "
                         f"{len(edge_data)} edge datasets")

    xs, ys, n_per_edge = _pad_edge_data(edge_data, dev)
    w_agg = (np.ones(n_edges) if n_samples is None
             else np.asarray(n_samples, np.float64))
    # f64 weights rounded to f32, as the reference's; kept in f64 for the
    # fused multiply-adds of the aggregation
    w_agg = [float(np.float32(w)) for w in w_agg / w_agg.sum()]

    if metric_fn is None:
        metric_fn = default_metric_fn(model, eval_set, metric_name)
    if cfg.utility == "eval_gain" and metric_fn is None:
        raise ValueError(
            "utility='eval_gain' needs a device metric; pass metric_fn= "
            "or use utility='param_delta'")

    local_block = make_local_block(model, xs, ys, n_per_edge, batch, lr, k)
    pos = torch.arange(max_rounds, device=dev)

    def weighted_mean(trees: Params) -> Params:
        """Σ_e w_e leaf_e in f32, edge by edge in order with one rounding
        per edge: XLA's ``einsum("e...,e->...")`` (a product, then fused
        multiply-adds)."""
        def mean(leaf):
            acc = (leaf[0].double() * w_agg[0]).float()
            for e in range(1, n_edges):
                acc = _fma32(leaf[e], w_agg[e], acc)
            return acc.to(leaf.dtype)
        return tree_map(mean, trees)

    def metric_of(params: Params) -> torch.Tensor:
        if metric_fn is not None:
            return metric_fn(params)
        return torch.full((), float("nan"), device=dev)

    def init(init_params: Params, knobs: Knobs, draws) -> Carry:
        hist = {
            "metric": torch.full((max_rounds,), float("nan"), device=dev),
            "utility": torch.zeros(max_rounds, device=dev),
            "interval": torch.zeros(max_rounds, dtype=torch.int32,
                                    device=dev),
            "consumed": torch.zeros(max_rounds, device=dev),
            "wall": torch.zeros(max_rounds, device=dev),
        }
        return {"params": tree_map(lambda p: p.to(dev, copy=True),
                                   init_params),
                "bstate": device_bandit_init(k, dev),
                "consumed": torch.zeros(n_edges, device=dev),
                "t": torch.zeros((), dtype=torch.int32, device=dev),
                "prev_metric": metric_of(init_params).reshape(()).float(),
                "wall": torch.zeros((), device=dev),
                "hist": hist}

    def cond(carry: Carry, knobs: Knobs) -> torch.Tensor:
        resid = knobs["budget"] - carry["consumed"]                  # [E]
        affordable = resid.amin() >= knobs["costs_k"].amin() - 1e-12
        exhausted = (resid < knobs["min_edge_cost"]).any()
        return (carry["t"] < max_rounds) & affordable & ~exhausted

    def body(carry: Carry, knobs: Knobs, draws: Dict[str, torch.Tensor]
             ) -> Carry:
        params, bstate = carry["params"], carry["bstate"]
        consumed, t = carry["consumed"], carry["t"]

        resid = (knobs["budget"] - consumed).amin()
        w = device_selection_weights(bstate, resid, knobs["costs_k"],
                                     knobs["ucb_c"])
        arm = torch.argmax(draws["gumbel"] + device_arm_logits(w))
        interval = arm + 1

        bcast = tree_map(lambda p: p.unsqueeze(0).expand(
            n_edges, *p.shape).contiguous(), params)
        edge_params = local_block(bcast, interval, draws["uniform"])
        new_params = weighted_mean(edge_params)

        # straggler semantics: every edge's clock advances by the slowest
        # edge's round time; each edge's realized cost is the expected
        # cost times max(0.1, 1 + noise * N(0, 1)) (0 noise: exactly 1)
        round_costs = _fma32(interval.float(), knobs["comp"], knobs["comm"])
        mult = torch.clamp(_fma32(knobs["cost_noise"], draws["normal"], 1.0),
                           min=0.1)
        slot = (round_costs * mult).amax()
        consumed = consumed + slot

        metric = metric_of(new_params)
        if cfg.utility == "eval_gain":
            utility = metric - carry["prev_metric"]
        else:                              # param_delta (§III.A)
            utility = 1.0 / (1.0 + _tree_l2(params, new_params))

        bstate = device_bandit_update(bstate, arm, utility, slot)
        wall = carry["wall"] + slot
        total = _edge_sum(consumed)
        at = pos == t
        hist = carry["hist"]
        hist = {
            "metric": torch.where(at, metric, hist["metric"]),
            "utility": torch.where(at, utility, hist["utility"]),
            "interval": torch.where(at, interval.int(), hist["interval"]),
            "consumed": torch.where(at, total, hist["consumed"]),
            "wall": torch.where(at, wall, hist["wall"]),
        }
        return {"params": new_params, "bstate": bstate,
                "consumed": consumed, "t": t + 1,
                "prev_metric": metric, "wall": wall, "hist": hist}

    def finalize(carry: Carry, knobs: Knobs) -> Tuple[Params, Dict]:
        out = dict(carry["hist"])
        out["n_rounds"] = carry["t"]
        out["budgets_left"] = knobs["budget"] - carry["consumed"]
        out["arm_pulls"] = carry["bstate"]["counts"]
        out["wall_time"] = carry["wall"]
        return carry["params"], out

    draw_shapes = {"gumbel": (k,), "uniform": (n_edges, k, batch),
                   "normal": (n_edges,)}
    return ELCell(init=init, cond=cond, body=body, finalize=finalize,
                  horizon=max_rounds, draw_shapes=draw_shapes, device=dev)


def _tree_copy_(dst, src) -> None:
    tree_map(lambda d, s: d.copy_(s), dst, src)


def _knob_tensor(value, device: torch.device) -> torch.Tensor:
    """A knob on the device: integers keep their dtype, floats are f32."""
    a = np.asarray(value)
    if a.dtype.kind not in "iu":
        a = a.astype(np.float32)
    return torch.as_tensor(a, device=device)


class ChunkRunner:
    """``program(init_params, knobs, draws) -> (params, out)``: a whole
    budgeted run of an :class:`ELCell` as chunks of ``rounds_per_chunk``
    masked steps, shared by the sync round (:class:`SyncProgram`) and the
    async engine (``repro_torch.el.events.program.AsyncProgram``).

    The carry, knobs and draws live in static device buffers; a chunk's
    draw buffers hold ``rounds_per_chunk x cell.items_per_step`` items from
    the RNG-seam provider, starting at the chunk's first item ``t``.  On a
    CUDA device the first run captures one chunk (warmed up once on a
    side stream, eagerly, its result discarded) into a
    ``torch.cuda.CUDAGraph`` that copies the chunk's result back into the
    carry and writes ``cond`` of it and the carry's ``t`` into ``status``;
    every chunk of every later run is a refill of the draw buffers, a
    replay and one read of ``status`` (the flag and the next chunk's
    first item).  Launches of ``kmeans_assign``'s batched entry recorded
    at capture are counted as (replays x launches per graph) in its
    wrapper's ``batched_launches``.  On the CPU the chunk runs eagerly,
    with the same read.

    ``out`` holds numpy arrays (one transfer after the loop); ``params``
    are copies of the final carry's.  ``last_run`` describes the latest
    run: chunks (= host syncs), graphs captured, replays and the batched
    kernel launches a graph holds.
    """

    def __init__(self, cell: ELCell, rounds_per_chunk: int = 16):
        self.cell = cell
        self.device = device = cell.device
        self.rounds_per_chunk = int(rounds_per_chunk)
        items = self.rounds_per_chunk * cell.items_per_step
        self.carry: Optional[Carry] = None
        self.knobs: Optional[Knobs] = None
        self.status = torch.ones(2, dtype=torch.int64, device=device)
        self.draw_bufs = {name: torch.zeros((items,) + shape, device=device)
                          for name, shape in cell.draw_shapes.items()}
        self.init_bufs = {name: torch.zeros(shape, device=device)
                          for name, shape in cell.init_draw_shapes.items()}
        self.graph = None
        self.launches_per_graph = 0
        self.graphs_captured = 0
        self.replays = 0
        self.last_run: Dict[str, Any] = {}

    @property
    def flag(self) -> torch.Tensor:
        """Whether the loop goes on after the latest chunk."""
        return self.status[0] != 0

    def _step_draws(self, r: int, t_base: torch.Tensor) -> Dict[str, Any]:
        """The draws step ``r`` of a chunk reads; ``t_base`` is the
        chunk's first item."""
        raise NotImplementedError

    def _chunk(self, carry: Carry) -> Carry:
        cell, knobs = self.cell, self.knobs
        t_base = carry["t"]
        for r in range(self.rounds_per_chunk):
            active = cell.cond(carry, knobs)
            new = cell.body(carry, knobs, self._step_draws(r, t_base))
            carry = tree_map(lambda n, o: torch.where(active, n, o), new,
                             carry)
        return carry

    def _step(self) -> None:
        """One chunk, the carry updated in place and the status set."""
        carry = self._chunk(self.carry)
        _tree_copy_(self.carry, carry)
        self.status[0].copy_(self.cell.cond(self.carry, self.knobs))
        self.status[1].copy_(self.carry["t"])

    def _capture(self) -> None:
        from repro_torch.kernels.kmeans_assign import ops as ka_ops
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):      # warm-up: library, plans, cuBLAS
            self._chunk(self.carry)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = ka_ops.batched_captured
        with torch.cuda.graph(graph):
            self._step()
        self.launches_per_graph = ka_ops.batched_captured - before
        self.graph = graph
        self.graphs_captured += 1

    def __call__(self, init_params: Params, knobs: Dict[str, Any], draws
                 ) -> Tuple[Params, Dict[str, np.ndarray]]:
        from repro_torch.kernels.kmeans_assign import ops as ka_ops
        dev = self.device
        knob_t = {name: _knob_tensor(v, dev) for name, v in knobs.items()}
        if self.init_bufs:
            draws.fill_init(self.init_bufs)
        init = self.cell.init(init_params, knob_t, self.init_bufs)
        if self.carry is None:
            self.knobs, self.carry = knob_t, init
        else:
            _tree_copy_(self.knobs, knob_t)
            _tree_copy_(self.carry, init)
        cuda = dev.type == "cuda"
        graphs_before, replays_before = self.graphs_captured, self.replays
        if cuda and self.graph is None:
            self._capture()
        chunks, t_next, horizon = 0, 0, self.cell.horizon
        while chunks * self.rounds_per_chunk < horizon:
            draws.fill(self.draw_bufs, t_next)
            if cuda:
                self.graph.replay()
                self.replays += 1
                ka_ops.add_replayed(self.launches_per_graph)
            else:
                self._step()
            chunks += 1
            go_on, t_next = self.status.tolist()   # the chunk's host sync
            if not go_on:
                break
        params, out = self.cell.finalize(self.carry, self.knobs)
        out = {name: v.cpu().numpy() for name, v in out.items()}
        params = tree_map(torch.clone, params)
        self.last_run = {
            "chunks": chunks, "rounds_per_chunk": self.rounds_per_chunk,
            "graphs_captured": self.graphs_captured - graphs_before,
            "replays": self.replays - replays_before,
            "kernel_launches_per_graph": self.launches_per_graph}
        return params, out


class SyncProgram(ChunkRunner):
    """The compiled sync round on a :class:`ChunkRunner`: step ``r`` of a
    chunk is round ``t + r`` and reads item ``r`` of the draw buffers."""

    def _step_draws(self, r: int, t_base: torch.Tensor) -> Dict[str, Any]:
        return {name: buf[r] for name, buf in self.draw_bufs.items()}


def make_sync_program(model, edge_data, eval_set, cfg: OL4ELConfig, *,
                      lr: float, batch: int,
                      n_samples: Optional[np.ndarray] = None,
                      metric_fn: Optional[Callable] = None,
                      metric_name: str = "accuracy",
                      max_rounds: int = 512, mesh=None, telemetry=None,
                      device: DeviceLike = None,
                      rounds_per_chunk: int = 16) -> SyncProgram:
    """Build ``program(init_params, knobs, draws) -> (params, out)`` — the
    whole budgeted sync run as device-resident chunks of masked rounds
    (see :class:`SyncProgram`), with the control-plane knobs
    (``KNOB_NAMES`` / ``sync_knobs``) as inputs so one program serves any
    (ucb_c, budget, cost) point, and the draws from an RNG-seam provider
    (``repro_torch.el.rng``).

    ``out`` holds per-round ``metric``, ``utility``, ``interval``,
    ``consumed`` (cumulative total across edges), ``wall`` (cumulative
    straggler time), plus ``n_rounds``, the final per-edge
    ``budgets_left``, ``arm_pulls`` and ``wall_time``.
    """
    cell = make_sync_cell(
        model, edge_data, eval_set, cfg, lr=lr, batch=batch,
        n_samples=n_samples, metric_fn=metric_fn, metric_name=metric_name,
        max_rounds=max_rounds, mesh=mesh, telemetry=telemetry,
        device=device)
    return SyncProgram(cell, rounds_per_chunk)

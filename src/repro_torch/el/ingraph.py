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
  mode             ``sync`` (async configs are coerced to sync by the
                   session; the async event engine is ROADMAP Queue 1
                   item 8)
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
from repro_torch.el.rng import ROUND_DRAWS
from repro_torch.interop import tree_leaves, tree_map
from repro_torch.models.classic import accuracy_tensor

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
        "  mode        'sync' (repro_torch.el.ingraph; the async event "
        "engine is ROADMAP Queue 1 item 8)\n"
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

        def accuracy(params: Params) -> torch.Tensor:
            return accuracy_tensor(model.scores(params, xe), ye)

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


def _tree_l2(a: Params, b: Params) -> torch.Tensor:
    total = None
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        s = ((x.float() - y.float()) ** 2).sum()
        total = s if total is None else total + s
    return torch.sqrt(total)


def make_local_block(model, xs: torch.Tensor, ys: torch.Tensor,
                     n_per_edge: torch.Tensor, batch: int, lr: float,
                     k: int) -> Callable:
    """``local_block(params, interval, uniform)`` — ``interval`` masked
    local iterations on every edge at once: ``params`` is the per-edge
    stack ``[E, ...]``, ``uniform`` the round's minibatch uniforms
    ``[E, k, batch]``.  Always ``k`` steps, steps past ``interval``
    masked, as the reference's fixed-length ``lax.scan``.  A step's
    indices are ``trunc(u * f32(n_e))`` (clamped to the padded length,
    as ``jnp`` indexing clamps), so a replayed uniform picks the
    reference's rows."""
    n_edges, n_max = xs.shape[0], xs.shape[1]
    rows = torch.arange(n_edges, device=xs.device)[:, None]      # [E, 1]
    n_f = n_per_edge.float()[:, None]                            # [E, 1]

    def local_block(params: Params, interval: torch.Tensor,
                    uniform: torch.Tensor) -> Params:
        for step in range(k):
            idx = (uniform[:, step] * n_f).long().clamp_(max=n_max - 1)
            b = {"x": xs[rows, idx], "y": ys[rows, idx]}         # [E, B, ...]
            p2 = model.step(params, b, lr)
            take = step < interval
            params = tree_map(lambda a, c: torch.where(take, c, a), params,
                              p2)
        return params

    return local_block


@dataclasses.dataclass(frozen=True)
class ELCell:
    """One EL run's loop, split into composable pieces.

    The closures share the program's dict carry (``carry["t"]`` is the
    round counter, ``carry["hist"]`` the ``[horizon]`` history arrays) and
    all take the knob dict explicitly.  ``body`` also takes the round's
    draws (``gumbel`` [K], ``uniform`` [E, k, batch], ``normal`` [E]),
    whose per-round shapes ``draw_shapes`` names.  ``SyncProgram`` fuses
    ``init → chunks of masked body → finalize``.
    """

    init: Callable       # (init_params, knobs) -> carry
    cond: Callable       # (carry, knobs) -> bool tensor (continue?)
    body: Callable       # (carry, knobs, draws) -> carry (one round)
    finalize: Callable   # (carry, knobs) -> (params, out dict)
    horizon: int         # history length (max_rounds)
    draw_shapes: Dict[str, Tuple[int, ...]]
    device: torch.device


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

    def init(init_params: Params, knobs: Knobs) -> Carry:
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
        total = consumed[0]
        for e in range(1, n_edges):        # the reference's order over E
            total = total + consumed[e]
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


class SyncProgram:
    """``program(init_params, knobs, draws) -> (params, out)``: the whole
    budgeted sync run as chunks of ``rounds_per_chunk`` masked rounds.

    The carry, knobs and draws live in static device buffers.  On a CUDA
    device the first run captures one chunk (warmed up once on a side
    stream, eagerly, its result discarded) into a ``torch.cuda.CUDAGraph``
    that copies the chunk's result back into the carry and writes ``cond``
    of it into a flag; every chunk of every later run is a refill of the
    draw buffers, a replay and one read of the flag.  Launches of
    ``kmeans_assign``'s batched entry recorded at capture are counted as
    (replays x launches per graph) in its wrapper's ``batched_launches``.
    On the CPU the chunk runs eagerly, with the same flag read.

    ``out`` holds numpy arrays (one transfer after the loop); ``params``
    are copies of the final carry's.  ``last_run`` describes the latest
    run: chunks (= host syncs), graphs captured, replays and the batched
    kernel launches a graph holds.
    """

    def __init__(self, cell: ELCell, rounds_per_chunk: int = 16):
        self.cell = cell
        self.device = device = cell.device
        self.rounds_per_chunk = int(rounds_per_chunk)
        self.carry: Optional[Carry] = None
        self.knobs: Optional[Knobs] = None
        self.flag: Optional[torch.Tensor] = None
        self.draw_bufs = {
            name: torch.zeros((self.rounds_per_chunk,) + shape,
                              device=device)
            for name, shape in cell.draw_shapes.items()}
        self.graph = None
        self.launches_per_graph = 0
        self.graphs_captured = 0
        self.replays = 0
        self.last_run: Dict[str, Any] = {}

    def _chunk(self, carry: Carry) -> Carry:
        cell, knobs = self.cell, self.knobs
        for r in range(self.rounds_per_chunk):
            active = cell.cond(carry, knobs)
            new = cell.body(carry, knobs,
                            {n: self.draw_bufs[n][r] for n in ROUND_DRAWS})
            carry = tree_map(lambda n, o: torch.where(active, n, o), new,
                             carry)
        return carry

    def _step(self) -> None:
        """One chunk, the carry updated in place and the flag set."""
        carry = self._chunk(self.carry)
        _tree_copy_(self.carry, carry)
        self.flag.copy_(self.cell.cond(self.carry, self.knobs))

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
        knob_t = {name: torch.as_tensor(np.asarray(v, np.float32),
                                        device=dev)
                  for name, v in knobs.items()}
        init = self.cell.init(init_params, knob_t)
        if self.carry is None:
            self.knobs, self.carry = knob_t, init
            self.flag = torch.ones((), dtype=torch.bool, device=dev)
        else:
            _tree_copy_(self.knobs, knob_t)
            _tree_copy_(self.carry, init)
        cuda = dev.type == "cuda"
        graphs_before, replays_before = self.graphs_captured, self.replays
        if cuda and self.graph is None:
            self._capture()
        chunks, horizon = 0, self.cell.horizon
        while chunks * self.rounds_per_chunk < horizon:
            draws.fill(self.draw_bufs, chunks * self.rounds_per_chunk)
            if cuda:
                self.graph.replay()
                self.replays += 1
                ka_ops.add_replayed(self.launches_per_graph)
            else:
                self._step()
            chunks += 1
            if not bool(self.flag):        # the chunk's one host sync
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

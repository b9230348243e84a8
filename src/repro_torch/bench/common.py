"""Shared harness utilities for the paper-figure replications.

The reference's ``benchmarks/common.py`` over the port: the same session
builds and run records, plus three things a run on the port needs.

* ``device=`` — ``None`` means CUDA (``resolve_device``); pass ``"cpu"``
  for the plain versions.  On a card K-means runs the ``kmeans_assign``
  kernel, with no fallback.
* ``init_params=`` — a numpy tree to start from (the reference draws its
  init from ``jax.random``, which torch cannot reproduce; carry it over
  as numpy).  ``None`` draws the port's own, :func:`default_init`.
* ``draws_for=`` — on the compiled rows, the RNG-seam provider
  (``repro_torch.el.rng``) of each run or sweep cell, as a callable
  ``draws_for(cfg, batch, horizon)`` of the run's config, its minibatch
  and its program's horizon.  ``None`` draws from each run's (or cell's)
  ``torch.Generator`` seeded with ``seed + 17``.
"""

from __future__ import annotations

import dataclasses
import subprocess
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import OL4ELConfig, get_config
from repro_torch.device import DeviceLike
from repro_torch.el import ELSession
from repro_torch.el.session import DEFAULT_SYNC_HORIZON
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.launch.classic import CLASSIC_RECIPES, classic_fixture
from repro_torch.models import build_model

# Paper workloads: ("svm", accuracy) and ("kmeans", F1).
WORKLOADS = ("svm", "kmeans")
ARCHS = {"svm": "svm-wafer", "kmeans": "kmeans-traffic"}

#: ``(workload, seed) -> numpy tree``: the init a figure's run starts from
InitFor = Callable[[str, int], Dict[str, np.ndarray]]
#: ``(cfg, batch, horizon) -> RNG-seam provider`` of a compiled run or cell
DrawsFor = Callable[[OL4ELConfig, int, int], Any]


@dataclasses.dataclass
class ELRun:
    workload: str
    policy: str
    mode: str
    heterogeneity: float
    n_edges: int
    budget: float
    final_metric: float
    n_aggregations: int
    total_consumed: float
    records: list
    seed: int = 0
    arm_pulls: List[int] = dataclasses.field(default_factory=list)


def _batch(workload: str, batch: Optional[int]) -> int:
    """The run's minibatch: ``batch``, else the workload's recipe's."""
    return batch or CLASSIC_RECIPES[ARCHS[workload]][2]


def default_init(workload: str, seed: int) -> Dict[str, np.ndarray]:
    """The port's init for ``seed``: ``model.init`` on a CPU generator
    seeded with it (so every device starts from the same values), as
    numpy."""
    model = build_model(get_config(ARCHS[workload]).model, device="cpu")
    return params_to_numpy(model.init(torch.Generator().manual_seed(seed)))


def make_el_session(workload: str, policy: str, mode: str,
                    heterogeneity: float, n_edges: int = 3,
                    budget: float = 5000.0, seed: int = 0,
                    n_data: int = 20000, cost_noise: float = 0.0,
                    cost_model: str = "fixed", max_interval: int = 10,
                    alpha: float = 100.0, async_alpha: float = 0.5,
                    lr: float | None = None,
                    batch: int | None = None,
                    scenario=None,
                    init_params: Optional[Dict[str, np.ndarray]] = None,
                    device: DeviceLike = None) -> ELSession:
    """Build a configured ``ELSession`` mirroring the paper's §V setup
    (dataset, config, executor, init params) — shared by the single-run
    and sweep harnesses.  The seed picks the data, the edge split and
    (unless ``init_params`` is given) the init.

    ``alpha`` is the Dirichlet concentration of the per-edge data split:
    the paper partitions data without skew, so the default is IID-like
    (alpha=100); pass alpha<=1 for the non-IID extension experiments.
    """
    fx = classic_fixture(ARCHS[workload], samples=n_data, n_edges=n_edges,
                         alpha=alpha, data_seed=seed, batch=batch, lr=lr,
                         device=device)
    ol = dataclasses.replace(
        fx["exp"].ol4el, mode=mode, policy=policy, n_edges=n_edges,
        budget=budget, heterogeneity=heterogeneity, utility=fx["utility"],
        seed=seed, cost_noise=cost_noise, cost_model=cost_model,
        max_interval=max_interval, scenario=scenario)
    init = (fx["init_params"] if init_params is None else
            params_from_numpy(init_params, fx["executor"].device))
    return ELSession(ol, metric_name=fx["metric"], lr=fx["lr"],
                     async_alpha=async_alpha).with_executor(
        fx["executor"], init_params=init, n_samples=fx["n_samples"])


def run_el(workload: str, policy: str, mode: str, heterogeneity: float,
           n_edges: int = 3, budget: float = 5000.0, seed: int = 0,
           n_data: int = 20000, cost_noise: float = 0.0,
           cost_model: str = "fixed", max_interval: int = 10,
           alpha: float = 100.0, async_alpha: float = 0.5,
           lr: float | None = None, batch: int | None = None,
           ingraph: bool = False,
           init_params: Optional[Dict[str, np.ndarray]] = None,
           draws_for: Optional[DrawsFor] = None,
           device: DeviceLike = None) -> ELRun:
    """One EL experiment through the ``repro_torch.el.ELSession`` façade.
    ``ingraph=True`` routes the run through the compiled fast path for
    its mode: ``run_sync_ingraph`` (sync) or ``run_async_ingraph`` (the
    ``repro_torch.el.events`` event-horizon program, async).  The
    session is closed when its run is taken.
    """
    from repro_torch.el.events import padded_event_horizon
    session = make_el_session(
        workload, policy, mode, heterogeneity, n_edges=n_edges,
        budget=budget, seed=seed, n_data=n_data, cost_noise=cost_noise,
        cost_model=cost_model, max_interval=max_interval, alpha=alpha,
        async_alpha=async_alpha, lr=lr, batch=batch,
        init_params=init_params, device=device)
    try:
        if not ingraph:
            res = session.run()
        elif mode == "sync":
            draws = None if draws_for is None else draws_for(
                session.cfg, _batch(workload, batch), DEFAULT_SYNC_HORIZON)
            res = session.run_sync_ingraph(draws=draws)
        else:
            draws = None if draws_for is None else draws_for(
                session.cfg, _batch(workload, batch),
                padded_event_horizon(session.cfg))
            res = session.run_async_ingraph(draws=draws)
    finally:
        session.close()
    return ELRun(workload, policy, mode, heterogeneity, n_edges, budget,
                 res.final_metric, res.n_aggregations, res.total_consumed,
                 res.records, seed=seed, arm_pulls=res.arm_pulls)


def run_el_sweep(workload: str, spec, heterogeneity: float = 6.0,
                 n_edges: int = 3, budget: float = 5000.0, seed: int = 0,
                 n_data: int = 20000, alpha: float = 100.0,
                 lr: float | None = None, batch: int | None = None,
                 mesh=None, scenario=None,
                 init_params: Optional[Dict[str, np.ndarray]] = None,
                 draws_for: Optional[DrawsFor] = None,
                 device: DeviceLike = None):
    """A whole (ucb_c × budget × heterogeneity × seeds) ablation grid as
    ONE device loop (``repro_torch.el.sweep``).  The base session is the
    same §V setup ``run_el`` uses with (ol4el, sync); returns the
    ``SweepReport``.  ``scenario=`` (a
    ``repro_torch.el.scenarios.ScenarioSpec``) runs the fleet-dynamics
    path, enabling the ``policy`` / ``churn_rate`` sweep axes.  ``mesh=``
    raises ``NotImplementedError`` (ROADMAP Queue 1 item 14).  The
    session is closed when its report is taken."""
    session = make_el_session(
        workload, "ol4el", "sync", heterogeneity, n_edges=n_edges,
        budget=budget, seed=seed, n_data=n_data, alpha=alpha, lr=lr,
        batch=batch, scenario=scenario, init_params=init_params,
        device=device)
    try:
        draws = None if draws_for is None else [
            draws_for(c, _batch(workload, batch), spec.max_rounds)
            for c in spec.cell_cfgs(session.cfg)]
        return session.sweep(spec, draws=draws, mesh=mesh)
    finally:
        session.close()


def mean_over_seeds(fn, seeds=(0, 1, 2)) -> Dict[str, float]:
    runs = [fn(seed=s) for s in seeds]
    return {
        "metric": float(np.mean([r.final_metric for r in runs])),
        "metric_std": float(np.std([r.final_metric for r in runs])),
        "aggs": float(np.mean([r.n_aggregations for r in runs])),
    }


def synchronize(device: torch.device) -> None:
    """Wait for ``device``'s queued work (a no-op on the CPU): every timed
    call of the benches ends in it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_meta(device: torch.device) -> Dict[str, str]:
    """``device_name`` / ``power_limit`` as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them (nothing on the
    CPU)."""
    if device.type != "cuda":
        return {}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    index = device.index if device.index is not None else 0
    name, limit = out.stdout.strip().splitlines()[index].rsplit(",", 1)
    return {"device_name": name.strip(), "power_limit": limit.strip()}


class Timer:
    def __init__(self):
        self.t0 = time.perf_counter()

    def us(self, n_calls: int = 1) -> float:
        return (time.perf_counter() - self.t0) * 1e6 / max(n_calls, 1)

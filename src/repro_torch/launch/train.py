"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

The port of ``repro.launch.train`` for the LM archs, on the card unless
``--device cpu``:

  * ``--mode standard`` -- plain synchronous training: a loop of train
    steps (grad, clip, AdamW) over the synthetic stream of edge 0;
  * ``--mode ol4el``    -- the paper's edge-cloud loop through
    ``ELSession``: E simulated edges, per-block intervals chosen by the
    budget-limited bandit, local blocks of train steps on an
    ``LMExecutor``, aggregation, budgets charged per the heterogeneous
    cost model (``run_sync`` or ``run_async(rng_streams="numpy")``,
    utility ``loss_delta``).

Parameters are the port's random init from a generator seeded with the
experiment's ``train.seed``.  Classic archs (svm-wafer, kmeans-traffic)
under ``--mode ol4el`` run the compiled programs on the device
(``train_classic_ol4el`` over the ``repro_torch.launch.classic``
fixture): ``--el-mode sync`` the sync round
(``ELSession.run_sync_ingraph``), ``--el-mode async`` the async event
engine (``ELSession.run_async_ingraph``, ``--async-batch-k`` its wave
width), and the scenario flags (``--churn``, ``--churn-period``,
``--cost-model``, ``--drift``; ``repro_torch.el.scenarios.cli``) inject
fleet dynamics into them.  Those flags need a classic arch under ``--mode
ol4el``, as the reference requires; so do ``--alpha`` (the Dirichlet
concentration of the edge data split) and ``--kmeans-impl`` (``cuda``:
the ``kmeans_assign`` kernel, the reference's ``pallas``; ``torch``: the
plain version, its ``jnp``).  ``--metrics-out`` writes the run's
metrics (``repro_torch.obs.cli``: the EL report's registry, Prometheus
text and JSON, and the tracer's spans) and ``--trace-dir`` a
``torch.profiler`` trace.  ``--telemetry [N]`` records the compiled
run's device rings (``repro_torch.obs.rings``) into the report (and,
with ``--metrics-out``, the ring series into the registry).  ``--ckpt
PATH`` saves the result in the reference's ``.npz`` format
(``repro_torch.train.checkpoint``): the final ``TrainState`` at step
``n_steps`` (standard), the EL report's final parameters at its
aggregation count (ol4el).  The reference's mesh and donation flags
(item 14) are not taken.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.config import get_config, get_smoke_config
from repro_torch.data import SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.el import ELSession
from repro_torch.el.report import ELReport
from repro_torch.federated import LMExecutor
from repro_torch.models import build_model
from repro_torch.obs.cli import (add_metrics_args, begin_observability,
                                 finish_observability, telemetry_arg)
from repro_torch.train import checkpoint, init_train_state, make_train_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_standard(exp, args) -> dict:
    """``args.steps`` (default 50) train steps on ``data.batch(0, i)``.
    Returns the final state, each step's metrics (floats) and its host
    time, the card synchronised after each step."""
    dev = resolve_device(args.device)
    n_steps = args.steps if args.steps is not None else 50
    model = build_model(exp.model, device=dev)
    state = init_train_state(
        model, exp.train,
        torch.Generator(device=dev).manual_seed(exp.train.seed))
    data = SyntheticLMData.for_model(exp.model, args.batch, args.seq)
    step = make_train_step(model, exp.train)
    history, step_s = [], []
    for i in range(n_steps):
        batch = data.batch(0, i, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        _sync(dev)
        step_s.append(time.perf_counter() - t0)
        history.append({k: float(v) for k, v in metrics.items()})
        if i % args.log_every == 0 or i == n_steps - 1:
            m = history[-1]
            print(f"step {i:5d} loss={m['loss']:.4f} lr={m['lr']:.2e} "
                  f"gnorm={m['grad_norm']:.2f} dt={step_s[-1]:.2f}s",
                  flush=True)
    if args.ckpt:
        checkpoint.save(args.ckpt, state, step=n_steps)
        print(f"saved checkpoint to {args.ckpt}")
    return {"state": state, "metrics": history, "step_s": step_s}


def _save_el(args, report) -> None:
    if args.ckpt:
        checkpoint.save(args.ckpt, report.final_params,
                        step=report.n_aggregations)
        print(f"saved EL checkpoint to {args.ckpt}")


def train_ol4el(exp, args):
    """The host EL loop over an ``LMExecutor``; returns the ``ELReport``."""
    dev = resolve_device(args.device)
    model = build_model(exp.model, device=dev)
    ol = dataclasses.replace(exp.ol4el, n_edges=args.edges,
                             heterogeneity=args.heterogeneity,
                             budget=args.budget, mode=args.el_mode,
                             async_alpha=args.async_alpha,
                             utility="loss_delta")
    ex = LMExecutor(model, exp.model, exp.train, batch=args.batch,
                    seq_len=args.seq, seed=exp.train.seed)

    def progress(rec):
        if rec.n_aggregations % args.log_every == 0:
            print(f"agg {rec.n_aggregations:4d} loss={rec.metric:.4f} "
                  f"interval={rec.interval:.0f} edge={rec.edge} "
                  f"consumed={rec.total_consumed:.0f}/"
                  f"{args.edges * args.budget:.0f}", flush=True)

    session = (ELSession(ol, metric_name="loss", lr=exp.train.peak_lr)
               .with_executor(ex)
               .on_round(progress))
    if ol.mode == "sync":
        report = session.run_sync(
            max_rounds=args.steps if args.steps is not None else 50)
    else:
        # without --steps the event horizon comes from budget / cost, so
        # the run ends on budget exhaustion; --steps caps it at
        # steps * edges events
        if args.steps is not None:
            print(f"async: --steps caps the run at "
                  f"{args.steps * args.edges} events (omit --steps to "
                  "run to budget exhaustion)", flush=True)
        report = session.run_async(
            max_events=None if args.steps is None
            else args.steps * args.edges)
    print(f"done: {report.n_aggregations} aggregations, "
          f"final loss {report.final_metric:.4f}, "
          f"consumed {report.total_consumed:.0f} "
          f"({report.terminated_reason}); arm pulls {report.arm_pulls}")
    _save_el(args, report)
    return report


def train_classic_ol4el(exp, args):
    """Classic archs through the compiled sync round or async event engine
    on the device, scenario-injected by the ``--churn`` / ``--cost-model``
    / ``--drift`` flags; returns the ``ELReport``."""
    from repro_torch.el.scenarios.cli import scenario_from_args
    from repro_torch.launch.classic import classic_fixture
    fx = classic_fixture(args.arch, samples=args.samples, n_edges=args.edges,
                         alpha=args.alpha, kmeans_impl=args.kmeans_impl,
                         device=args.device)
    metric = fx["metric"]
    scenario, base_cost_model = scenario_from_args(args)
    ol = dataclasses.replace(fx["exp"].ol4el, n_edges=args.edges,
                             heterogeneity=args.heterogeneity,
                             budget=args.budget, mode=args.el_mode,
                             async_alpha=args.async_alpha,
                             async_batch_k=args.async_batch_k,
                             policy="ol4el", utility=fx["utility"],
                             cost_model=base_cost_model, scenario=scenario)
    session = (ELSession(ol, metric_name=metric, lr=fx["lr"])
               .with_executor(fx["executor"], init_params=fx["init_params"],
                              n_samples=fx["n_samples"]))
    print(f"ol4el {args.arch}: compiled {ol.mode} run, {args.edges} edges "
          f"on {fx['executor'].device}"
          + ("" if scenario is None else f", scenario {scenario}"),
          flush=True)
    if ol.mode == "sync":
        report = session.run_sync_ingraph(
            max_rounds=args.steps if args.steps is not None else 256,
            telemetry=args.telemetry)
    else:
        # as train_ol4el: an explicit --steps caps the run at steps * edges
        # events, announced, never silently
        if args.steps is not None:
            print(f"async: --steps caps the run at "
                  f"{args.steps * args.edges} events (omit --steps to "
                  "run to budget exhaustion)", flush=True)
        report = session.run_async_ingraph(
            max_events=None if args.steps is None
            else args.steps * args.edges, telemetry=args.telemetry)
    loop = report.telemetry["device_loop"]
    print(f"done: {report.n_aggregations} aggregations, "
          f"final {metric} {report.final_metric:.4f}, "
          f"consumed {report.total_consumed:.0f} "
          f"({report.terminated_reason}); arm pulls {report.arm_pulls}; "
          f"{loop['chunks']} chunks of {loop['rounds_per_chunk']} rounds, "
          f"{loop['replays']} graph replays", flush=True)
    _save_el(args, report)
    return report


def parser() -> argparse.ArgumentParser:
    from repro_torch.el.scenarios.cli import add_scenario_args
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--mode", default="standard",
                    choices=["standard", "ol4el"])
    ap.add_argument("--el-mode", default="async", choices=["sync", "async"])
    ap.add_argument("--async-alpha", type=float, default=0.5,
                    help="async staleness-mix base rate (cfg.async_alpha)")
    ap.add_argument("--async-batch-k", type=int, default=0,
                    help="classic archs, compiled async engine: K-event "
                         "wave width (cfg.async_batch_k; 0 resolves to 1)")
    ap.add_argument("--steps", type=int, default=None,
                    help="standard/sync: training steps/rounds (default "
                         "50); async: optional event cap of steps*edges "
                         "— omitted, the run goes to budget exhaustion")
    ap.add_argument("--batch", type=int, default=None,
                    help="sequences per step (default: the experiment's "
                         "train.global_batch, 8 at full width)")
    ap.add_argument("--seq", type=int, default=None,
                    help="tokens per sequence (default: the experiment's "
                         "train.seq_len, 512 at full width)")
    ap.add_argument("--edges", type=int, default=4)
    ap.add_argument("--heterogeneity", type=float, default=4.0)
    ap.add_argument("--budget", type=float, default=1e5)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--ckpt", default=None,
                    help="save the trained state (standard) or the EL "
                         "run's final parameters (ol4el) to this .npz")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, required)")
    ap.add_argument("--samples", type=int, default=4000,
                    help="classic-arch dataset size (ol4el mode)")
    ap.add_argument("--alpha", type=float, default=100.0,
                    help="Dirichlet concentration of the classic edge "
                         "data split (matches repro_torch.launch.sweep)")
    ap.add_argument("--kmeans-impl", default=None, choices=["cuda", "torch"],
                    help="K-means E-step engine for the local blocks "
                         "(default: the device's path; cuda: the "
                         "kmeans_assign kernel, the reference's 'pallas'; "
                         "torch: the plain version, the reference's "
                         "'jnp'; cuda on a CPU device raises)")
    add_scenario_args(ap)
    add_metrics_args(ap, trace_dir=True)
    telemetry_arg(ap)
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    return parser().parse_args(argv)


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    exp = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    classic_el = args.mode == "ol4el" and exp.model.family == "classic"
    scenario_flags = (args.churn is not None or args.drift is not None
                      or args.cost_model not in ("fixed", "variable"))
    if (scenario_flags or args.telemetry is not None) and not classic_el:
        ap.error("--telemetry/--churn/--drift and the scenario "
                 "--cost-model kinds drive the compiled single-run "
                 "programs, which need a classic arch under --mode ol4el "
                 "(LM archs and --mode standard run the host loops)")
    if exp.model.family == "classic" and args.mode != "ol4el":
        raise ValueError(f"{args.arch}: classic archs train under "
                         "--mode ol4el (the compiled EL round)")
    begin_observability(args)
    if classic_el:
        report = train_classic_ol4el(exp, args)
    else:
        if args.batch is None:
            args.batch = exp.train.global_batch
        if args.seq is None:
            args.seq = exp.train.seq_len
        report = (train_standard(exp, args) if args.mode == "standard"
                  else train_ol4el(exp, args))
    registry = None
    if args.metrics_out and isinstance(report, ELReport):
        from repro_torch.obs import registry_from_report
        registry = registry_from_report(
            report, labels={"arch": args.arch, "mode": report.mode})
    finish_observability(args, registry)
    return report


if __name__ == "__main__":
    main()

"""Microbenchmarks: control-plane and kernel-path costs on the card.

The reference's ``benchmarks/microbench.py`` over the port, emitted in the
harness CSV contract (``name,us_per_call,derived``) under the reference's
row names, in its order.  Every timed call ends in
``torch.cuda.synchronize()`` on a card (the reference's ends in
``block_until_ready``); on the CPU the numbers are the plain versions'
costs on this host, not the card's.

On a CUDA device one row is added after the E-step's plain row:
``kmeans_assign_n4096_d64_k3``, the ``kmeans_assign`` kernel on the same
inputs, timed with CUDA events.  Its ``derived`` field carries its
launches and its largest distance error against the plain row's output;
the row also holds them as ``launches`` / ``max_abs_err``, with
``assign_mismatches`` (assignments that differ from the plain version's)
and ``beyond_allowed`` (distances outside ``ref.allowed_error``).

``--sharded`` adds the reference's four donated and mesh-sharded rows
after the sweep's, from one ``repro_torch.bench.bench_el`` run at the
reference's sizes (``SHARDED_BENCH``; its sharded tiers run in 4 gloo
ranks, sharing the one card).

    PYTHONPATH=src python -m repro_torch.bench.microbench [--device cpu]
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.bench.common import synchronize
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs.timing import repeat_s
from repro_torch.obs.timing import timeit_us as _time

#: the ``bench_el`` run behind the sharded rows: the reference's
#: (``benchmarks/microbench.py:230-233``)
SHARDED_BENCH = ["--skip-host", "--repeats", "3", "--samples", "2000",
                 "--budget", "2000", "--max-rounds", "48",
                 "--max-events", "128"]

#: the E-step rows' inputs: 4096 points of 64 features, 3 centres
KM_N, KM_D, KM_K = 4096, 64, 3


def kmeans_inputs(device: DeviceLike = None):
    """The E-step rows' ``(x [4096, 64], centres [3, 64])``, f32 standard
    normals from numpy generators seeded 2 and 3 (the reference draws
    them from ``jax.random.key(2)`` / ``key(3)``)."""
    dev = resolve_device(device)
    x = np.random.default_rng(2).standard_normal((KM_N, KM_D))
    c = np.random.default_rng(3).standard_normal((KM_K, KM_D))
    return (torch.tensor(x, dtype=torch.float32, device=dev),
            torch.tensor(c, dtype=torch.float32, device=dev))


def _synced(fn, dev: torch.device):
    """``fn`` followed by ``synchronize(dev)``."""
    def call():
        out = fn()
        synchronize(dev)
        return out
    return call


def _cuda_us(fn, n: int = 20, warmup: int = 3) -> float:
    """Mean µs per call of ``fn`` over ``n`` calls by CUDA events (host
    enqueue included, as a caller makes them), after ``warmup``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / n


def kmeans_kernel_row(x: torch.Tensor, c: torch.Tensor) -> Dict:
    """The ``kmeans_assign`` kernel row on a card, held to the plain
    version on the same inputs."""
    from repro_torch.kernels.kmeans_assign import ops, ref
    if x.device.type != "cuda":
        raise ValueError("the kmeans_assign kernel row runs on a CUDA "
                         "device: on the CPU the wrapper is the plain "
                         "version")
    before = ops.launches
    a, d2 = ops.assign_with_dist(x, c)
    a_ref = ref.assign_ref(x, c)[0]
    d2_ref, allowed = ref.allowed_error(x, c)
    torch.cuda.synchronize()
    err = float((d2 - d2_ref).abs().max())
    mismatches = int((a != a_ref).sum())
    beyond = int(((d2 - d2_ref).abs() > allowed).sum())
    us = _cuda_us(lambda: ops.assign_with_dist(x, c))
    launches = ops.launches - before
    return dict(name=f"kmeans_assign_n{KM_N}_d{KM_D}_k{KM_K}",
                us_per_call=us,
                derived=f"Estep,launches={launches},"
                        f"max_abs_err={err:.3g}",
                launches=launches, max_abs_err=err,
                assign_mismatches=mismatches, beyond_allowed=beyond)


def el_fixture(device: DeviceLike = None):
    """The reference's EL fixture (``microbench.py:94-108``): svm-wafer on
    2,000 samples over 3 edges (Dirichlet alpha 1), budget 6000,
    heterogeneity 6, batch 64, lr 0.05.  Returns ``(cfg, executor,
    n_samples)``."""
    from repro_torch.config import get_config
    from repro_torch.data import make_wafer_dataset, partition_edges
    from repro_torch.federated import ClassicExecutor
    from repro_torch.models import build_model
    dev = resolve_device(device)
    train_d, test_d = make_wafer_dataset(n=2000, seed=0)
    exp = get_config("svm-wafer")
    svm = build_model(exp.model, device=dev)
    ol = dataclasses.replace(exp.ol4el, mode="sync", policy="ol4el",
                             n_edges=3, budget=6000.0, heterogeneity=6.0,
                             utility="eval_gain", seed=0)
    edges = partition_edges(train_d, 3, alpha=1.0, seed=0)
    ex = ClassicExecutor(svm, edges, test_d, batch=64, lr=0.05, device=dev)
    return ol, ex, [len(e["y"]) for e in edges]


def run(quiet: bool = False, sharded: bool = False, fleet: bool = False,
        device: DeviceLike = None) -> List[Dict]:
    """The reference's rows on ``device`` (default CUDA).
    ``sharded=True`` adds the donated and mesh-sharded single-run rows
    (:func:`_sharded_rows`); ``fleet=True`` adds the multi-tenant serving
    row from the port's ``bench_fleet`` (``--tenants 64 --repeats 1``, in
    this process, no history entry)."""
    dev = resolve_device(device)
    rows = []

    # bandit decision latency (cloud control plane, numpy on the host)
    from repro_torch.core.bandit import BanditState, arm_costs, select_arm
    st = BanditState.create(10)
    costs = arm_costs(10, 10.0, 50.0)
    rng = np.random.default_rng(0)
    for i in range(10):
        st.update(i, 0.5, costs[i])
    rows.append(dict(name="bandit_select_arm",
                     us_per_call=_time(lambda: select_arm(st, 1e4, costs,
                                                          "ol4el", rng)),
                     derived="decisions/s"))

    # weighted average aggregation (1M params, 4 edges)
    from repro_torch.federated import weighted_average
    trees = [{"w": torch.ones((1024, 256), device=dev)} for _ in range(4)]
    rows.append(dict(name="aggregate_1M_params_4edges",
                     us_per_call=_time(_synced(
                         lambda: weighted_average(trees, [1.0] * 4), dev),
                         n=20),
                     derived="params_avg"))

    # blocked attention step (the long-sequence path), small shape; the
    # reference's row name
    from repro_torch.config import ModelConfig
    from repro_torch.interop import tree_map
    from repro_torch.models import layers as L
    cfg = ModelConfig(d_model=256, n_heads=4, n_kv_heads=4, dtype="float32")
    p = tree_map(lambda t: t.to(dev),
                 L.init_attention(torch.Generator().manual_seed(0), cfg))
    x = torch.randn((1, 512, 256),
                    generator=torch.Generator().manual_seed(1)).to(dev)
    pos = torch.arange(512, device=dev)

    @torch.inference_mode()
    def att():
        return L.attention(p, cfg, x, pos, impl="blocked")
    rows.append(dict(name="xla_blocked_attention_b1_s512_d256",
                     us_per_call=_time(_synced(att, dev), n=10),
                     derived="fwd"))

    # K-means E-step: the plain version, then (on a card) the kernel
    from repro_torch.kernels.kmeans_assign import ref
    xk, ck = kmeans_inputs(dev)
    rows.append(dict(name=f"kmeans_assign_ref_n{KM_N}_d{KM_D}_k{KM_K}",
                     us_per_call=_time(_synced(
                         lambda: ref.assign_ref(xk, ck), dev), n=20),
                     derived="Estep"))
    if dev.type == "cuda":
        rows.append(kmeans_kernel_row(xk, ck))

    def timed(fn):
        """``(fn(), its µs)``, the clock stopped after a synchronize."""
        fn = _synced(fn, dev)
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e6

    # simulator round throughput (SVM, 3 edges)
    from repro_torch.bench.common import run_el
    r, dt = timed(lambda: run_el("svm", "ol4el", "async", 6.0,
                                 budget=1500.0, n_data=2000, device=dev))
    rows.append(dict(name="el_sim_svm_async_per_aggregation",
                     us_per_call=dt / max(r.n_aggregations, 1),
                     derived=f"acc={r.final_metric:.3f}"))

    # host-driven sync loop vs the compiled sync round (chunks of masked
    # rounds, a CUDA graph replay each on a card): per-aggregation cost,
    # warm in both cases
    from repro_torch.el import ELSession
    ol, ex, ns = el_fixture(dev)

    def session():
        return ELSession(ol, metric_name="accuracy", lr=0.05) \
            .with_executor(ex, n_samples=ns)

    session().run_sync()                        # warm the host loop
    host, host_us = timed(lambda: session().run_sync())
    host_us /= max(host.n_aggregations, 1)
    rows.append(dict(name="el_sync_host_per_round", us_per_call=host_us,
                     derived=f"acc={host.final_metric:.3f}"))

    sess = session()
    sess.run_sync_ingraph()                     # build + capture
    ing, ing_us = timed(sess.run_sync_ingraph)
    ing_us /= max(ing.n_aggregations, 1)
    rows.append(dict(
        name="el_sync_ingraph_per_round", us_per_call=ing_us,
        derived=f"acc={ing.final_metric:.3f},"
                f"speedup={host_us / max(ing_us, 1e-9):.1f}x_vs_host"))

    # the device telemetry rings: per-round cost of the instrumented sync
    # program vs the bare one, both warm, min-of-3 (the acceptance bound
    # is <10% overhead per round)
    sess.run_sync_ingraph(telemetry=64)         # build + capture ringed
    off_us = min(repeat_s(_synced(sess.run_sync_ingraph, dev), 3)) * 1e6 \
        / max(ing.n_aggregations, 1)
    on = sess.run_sync_ingraph(telemetry=64)
    on_us = min(repeat_s(_synced(
        lambda: sess.run_sync_ingraph(telemetry=64), dev), 3)) * 1e6 \
        / max(on.n_aggregations, 1)
    rows.append(dict(
        name="el_telemetry_overhead_per_round",
        us_per_call=max(on_us - off_us, 0.0),
        derived=f"on={on_us:.0f}us,off={off_us:.0f}us,overhead="
                f"{(on_us - off_us) / max(off_us, 1e-9) * 100:.1f}pct"))

    # host-driven async event queue vs the compiled event engine (finish
    # times in a tensor, masked merges, no host priority queue):
    # per-event cost, warm in both cases
    ol_async = dataclasses.replace(ol, mode="async")

    def async_session():
        return ELSession(ol_async, metric_name="accuracy", lr=0.05) \
            .with_executor(ex, n_samples=ns)

    async_session().run_async()                 # warm the host loop
    ahost, ahost_us = timed(lambda: async_session().run_async())
    ahost_us /= max(ahost.n_aggregations, 1)
    rows.append(dict(name="el_async_host_per_event", us_per_call=ahost_us,
                     derived=f"acc={ahost.final_metric:.3f}"))

    asess = async_session()
    asess.run_async_ingraph()                   # build + capture
    aing, aing_us = timed(asess.run_async_ingraph)
    aing_us /= max(aing.n_aggregations, 1)
    rows.append(dict(
        name="el_async_ingraph_per_event", us_per_call=aing_us,
        derived=f"acc={aing.final_metric:.3f},"
                f"speedup={ahost_us / max(aing_us, 1e-9):.1f}x_vs_host"))

    # ablation sweep: 4 (ucb_c x seed) cells as ONE device loop vs the
    # sequential host-loop equivalent; per-grid wall-clock, warm in both
    from repro_torch.el.sweep import SweepSpec
    spec = SweepSpec(ucb_c=(1.0, 2.0), budget=(3000.0,), seeds=(0, 1),
                     max_rounds=128)

    def seq_host():
        for ccfg in spec.cell_cfgs(ol):
            ELSession(ccfg, metric_name="accuracy", lr=0.05) \
                .with_executor(ex, n_samples=ns).run_sync()
    seq_host_us = timed(seq_host)[1]
    sw = session()
    sw.sweep(spec)                              # build + capture the sweep
    rep_sw, sweep_us = timed(lambda: sw.sweep(spec))
    rows.append(dict(
        name="el_sweep_vmapped_4cells", us_per_call=sweep_us,
        derived=f"acc={float(np.nanmean(rep_sw.final_metrics())):.3f},"
                f"speedup={seq_host_us / max(sweep_us, 1e-9):.1f}"
                "x_vs_seq_host"))

    # the donated and mesh-sharded single-run rows (bench_el's tiers)
    if sharded:
        rows.extend(_sharded_rows(dev))

    # multi-tenant EL serving: a FleetServer cohort (slot waves with
    # mid-flight refill) vs sequential per-tenant sessions
    if fleet:
        rows.extend(_fleet_rows(dev))

    if not quiet:
        for row in rows:
            print(f"micro {row['name']:40s} {row['us_per_call']:12.1f} us  "
                  f"{row['derived']}", flush=True)
    return rows


def _sharded_rows(dev: torch.device) -> List[Dict]:
    """The reference's four rows from one ``bench_el`` run
    (``SHARDED_BENCH``, no history entry): the sync donated and sharded
    tiers per round and the async sharded tier per event, each beside
    its unsharded tier."""
    import json

    from repro_torch.bench import bench_el
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "bench_el.json")
        bench_el.main(SHARDED_BENCH + ["--device", str(dev), "--no-history",
                                       "--out", out])
        with open(out) as f:
            sub = json.load(f)["rows"]

    def peak(row):
        p = row.get("peak_live_bytes")
        return "n/a" if p is None else f"{p / 1e6:.2f}MB"

    rows = []
    base = sub["el_sync_ingraph"]
    for name, tag in (("el_sync_ingraph_donate", "donated"),
                      ("el_sync_sharded", "sharded_2x2"),
                      ("el_sync_sharded_donate", "sharded_donated")):
        row = sub[name]
        speedup = base["us_per_aggregation"] / max(
            row["us_per_aggregation"], 1e-9)
        rows.append(dict(
            name=f"{name}_per_round", us_per_call=row["us_per_aggregation"],
            derived=f"{tag},speedup={speedup:.1f}x_vs_replicated,"
                    f"peak={peak(row)}(vs{peak(base)}),"
                    f"alias={row.get('alias_bytes', 0)}B"))
    abase, arow = sub["el_async_ingraph"], sub["el_async_sharded"]
    speedup = abase["us_per_aggregation"] / max(arow["us_per_aggregation"],
                                                1e-9)
    rows.append(dict(
        name="el_async_sharded_per_event",
        us_per_call=arow["us_per_aggregation"],
        derived=f"speedup={speedup:.1f}x_vs_replicated,"
                f"peak={peak(arow)}(vs{peak(abase)})"))
    return rows


def _fleet_rows(dev: torch.device) -> List[Dict]:
    import json

    from repro_torch.bench import bench_fleet
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "bench_fleet.json")
        bench_fleet.main(["--tenants", "64", "--repeats", "1",
                          "--device", str(dev), "--no-history",
                          "--out", out])
        with open(out) as f:
            sub = json.load(f)["rows"]
    flt = sub["fleet_64"]
    return [dict(
        name="fleet_tenants_per_sec",
        us_per_call=1e6 / max(flt["tenants_per_sec"], 1e-9),
        derived=f"{flt['tenants_per_sec']:.1f}t/s,"
                f"speedup={flt['speedup_vs_sequential_host']:.1f}"
                "x_vs_seq_host,"
                f"{flt['speedup_vs_sequential_ingraph']:.1f}"
                "x_vs_seq_ingraph,"
                f"waves={flt['waves']},compiles={flt['compiles']}")]


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--sharded", action="store_true",
                    help="also run the donated and mesh-sharded single-run "
                         "rows (bench_el's tiers; 4 gloo ranks)")
    ap.add_argument("--fleet", action="store_true",
                    help="also run the multi-tenant fleet serving row "
                         "(the port's bench_fleet, in this process)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    _a = ap.parse_args()
    run(sharded=_a.sharded, fleet=_a.fleet, device=_a.device)

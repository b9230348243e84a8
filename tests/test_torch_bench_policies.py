"""The port's policy ablation, churn baselines and §V testbed
(``repro_torch.bench.{policy_ablation,churn_baselines,testbed}``) vs the
reference's (``benchmarks/policy_ablation.py``,
``benchmarks/churn_baselines.py``, ``examples/el_svm_testbed.py``), on
the CPU.

The synthetic bandit is numpy only on both sides, so its ``oracle_frac``
must be exactly the reference's.  The testbed rows are host runs (the
reference's decisions, metrics within the flip bound); ``ucb_sweep`` and
the churn grid are compiled sweeps, held cell by cell to the reference's
on its ``jax.random`` draws replayed through the RNG seam.  Helpers and
tiers are ``tests/test_torch_bench_figs.py``'s.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_bench_figs import (ROOT, assert_same_rows,  # noqa: E402
                                   assert_same_runs, capture, decisions,
                                   one_torch_thread, ref_draws, ref_init)

from benchmarks import churn_baselines as ref_churn  # noqa: E402
from benchmarks import policy_ablation as ref_pol  # noqa: E402
from repro.el import ELSession as JaxSession  # noqa: E402
from repro_torch.bench import churn_baselines  # noqa: E402
from repro_torch.bench import policy_ablation, testbed  # noqa: E402
from repro_torch.el import ELSession  # noqa: E402

CPU = "cpu"


@pytest.mark.parametrize("policy", policy_ablation.POLICIES)
def test_synthetic_bandit_oracle_frac_is_exactly_the_references(policy):
    for seed in (0, 1):
        assert policy_ablation.synthetic_bandit(policy, seed) == \
            ref_pol.synthetic_bandit(policy, seed)


def test_run_without_testbed_is_the_references_rows():
    assert policy_ablation.POLICIES == ref_pol.POLICIES
    assert policy_ablation.run(seeds=(0, 1), with_testbed=False,
                               quiet=True, device=CPU) == \
        ref_pol.run(seeds=(0, 1), with_testbed=False, quiet=True)


def test_el_testbed_matches_reference(monkeypatch):
    ref_seen = capture(monkeypatch, JaxSession)
    port_seen = capture(monkeypatch, ELSession)
    ref_acc = [ref_pol.el_testbed(p, 0) for p in ref_pol.POLICIES]
    port_acc = [policy_ablation.el_testbed(p, 0, init_for=ref_init,
                                           device=CPU)
                for p in policy_ablation.POLICIES]
    bound = assert_same_runs(port_seen, ref_seen)
    assert [k for k, *_ in port_seen] == ["run"] * 7
    for p, r in zip(port_acc, ref_acc):
        assert abs(p - r) <= bound


@pytest.mark.parametrize("module", ["policy_ablation", "churn_baselines"])
def test_smoke_grid_matches_reference_on_replayed_draws(monkeypatch, module):
    """``ucb_sweep`` at the ``--smoke`` grid (ucb_c 1 / 4 × seeds 0 / 1,
    1,000 samples, 64 rounds) and the churn grid at its ``--smoke`` grid
    (3 policies × churn 0 / 0.4, seed 0): every cell the reference's on
    its replayed draws, the rows within the flip bound."""
    ref_seen = capture(monkeypatch, JaxSession)
    port_seen = capture(monkeypatch, ELSession)
    if module == "policy_ablation":
        kw = dict(seeds=(0, 1), ucb_grid=(1.0, 4.0), budget=800.0,
                  n_data=1000, max_rounds=64, quiet=True)
        ref_rows = ref_pol.ucb_sweep(**kw)
        port_rows = policy_ablation.ucb_sweep(
            **kw, init_for=ref_init, draws_for=ref_draws, device=CPU)
        n_rows = 2
    else:
        kw = dict(seeds=(0,), rates=(0.0, 0.4), budget=800.0, n_data=1000,
                  max_rounds=64, quiet=True)
        ref_rows = ref_churn.run(**kw)
        port_rows = churn_baselines.run(
            **kw, init_for=ref_init, draws_for=ref_draws, device=CPU)
        n_rows = 6
        out = port_seen[0][3].out
        assert (out["active_edges"] < 3).any()      # the churn bit
        np.testing.assert_array_equal(out["active_edges"],
                                      ref_seen[0][3].out["active_edges"])
    assert [k for k, *_ in port_seen] == ["sweep"]
    bound = assert_same_runs(port_seen, ref_seen)
    assert len(port_rows) == n_rows
    assert_same_rows(port_rows, ref_rows, bound)


def test_smoke_mains_pass_on_the_cpu(capsys):
    policy_ablation.main(["--smoke", "--device", "cpu"])
    churn_baselines.main(["--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "sweep smoke OK" in out and "churn baselines smoke OK" in out


def test_churn_main_writes_the_ports_own_record(monkeypatch, tmp_path):
    """The default output is under ``results/`` (gitignored), never the
    reference's ``BENCH_churn_baselines.json``."""
    rows = [dict(figure="churn_baselines", policy="ol4el", churn_rate=0.0,
                 n_seeds=3, metric=0.9, metric_std=0.0, consumed=1.0)]
    monkeypatch.setattr(churn_baselines, "run", lambda **kw: rows)
    monkeypatch.chdir(tmp_path)
    churn_baselines.main(["--device", "cpu"])
    written = tmp_path / "results" / "torch_churn_baselines.json"
    assert json.loads(written.read_text())["rows"] == rows
    assert list(tmp_path.iterdir()) == [tmp_path / "results"]
    assert not churn_baselines.DEFAULT_OUT.endswith(
        "BENCH_churn_baselines.json")


def _reference_testbed():
    spec = importlib.util.spec_from_file_location(
        "ref_el_svm_testbed",
        os.path.join(ROOT, "examples", "el_svm_testbed.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_testbed_matches_reference(monkeypatch, capsys):
    """The §V table at 2,000 samples, budget 1200: every row's run the
    reference example's (``ucb_bv`` under variable cost, noise 0.2, on the
    same numpy streams), the printed table line for line."""
    ref_seen = capture(monkeypatch, JaxSession)
    port_seen = capture(monkeypatch, ELSession)
    monkeypatch.setattr("sys.argv", ["el_svm_testbed.py", "--samples",
                                     "2000", "--budget", "1200"])
    _reference_testbed().main()
    ref_text = capsys.readouterr().out
    rows = testbed.main(["--samples", "2000", "--budget", "1200",
                         "--device", "cpu"])
    port_text = capsys.readouterr().out
    assert [k for k, *_ in port_seen] == ["run"] * 5
    assert assert_same_runs(port_seen, ref_seen) > 0
    assert port_text == ref_text
    assert [r["algo"] for r in rows] == [f"{p}-{m}"
                                         for p, m in testbed.ALGOS]
    assert [r["decisions"] for r in rows] == \
        [decisions(rep) for *_, rep in port_seen]
    assert port_seen[4][3].arm_pulls == rows[4]["arm_pulls"]


def test_testbed_ingraph_routes_ol4el_sync_through_the_compiled_round(
        monkeypatch):
    seen = capture(monkeypatch, ELSession)
    rows = testbed.run(n_data=800, budget=600.0, ingraph=True, quiet=True,
                       device=CPU)
    assert [k for k, *_ in seen] == ["run_sync_ingraph"] + ["run"] * 4
    assert all(0.0 < r["metric"] <= 1.0 for r in rows)

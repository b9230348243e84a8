"""The port's program profiles and collective contracts
(``repro_torch.obs.prof``) vs the reference's (``repro.obs.prof``), on
the CPU.

Tier: exact.  The profile's JSON and accessors, the contracts' checks
(message for message, but the unavailable-alias wording, which names the
compiler analysis in the reference), ``default_contract`` and
``param_tree_bytes`` must equal the reference's on the same inputs.  The
session and fleet wiring follows the reference's ``tests/test_prof.py``
cases that need neither a mesh nor HLO: a profile attached and cached
once, no collectives and nothing aliased for a solo program, a violated
contract raising before the run, the cohort's (donated) profile on every
tenant report.  On the CPU the allocator keeps no peak statistics, so
``temp_bytes`` and ``peak_live_bytes`` are ``None`` with the reason in
``errors``; the card's values are checked by ``chip_smoke.py``.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs import prof as jax_prof  # noqa: E402
from repro_torch.el import ELSession, FleetServer, TenantRun  # noqa: E402
from repro_torch.el import ingraph  # noqa: E402
from repro_torch.el.rng import TorchDraws  # noqa: E402
from repro_torch.launch.classic import classic_fixture  # noqa: E402
from repro_torch.obs import prof  # noqa: E402


@pytest.fixture(scope="module")
def svm():
    return classic_fixture("svm-wafer", samples=128, n_edges=4,
                           alpha=100.0, data_seed=0, device="cpu")


def _cfg(fx, mode, budget, seed=0):
    return dataclasses.replace(
        fx["exp"].ol4el, mode=mode, policy="ol4el", n_edges=4,
        utility=fx["utility"], budget=float(budget), seed=seed)


def _session(fx, cfg):
    return (ELSession(cfg, metric_name=fx["metric"])
            .with_executor(fx["executor"], init_params=fx["init_params"],
                           n_samples=(fx["n_samples"]
                                      if cfg.mode == "sync" else None)))


# -- ProgramProfile + contracts (pure) ----------------------------------------


PROFILES = [dict(collectives={"all-gather": {"count": 2, "bytes": 100}},
                 collective_bytes=100, alias_bytes=0, flops=1e6),
            dict(peak_live_bytes=3_500_000, alias_bytes=1920, donated=True,
                 errors=("memory: withheld",)),
            dict()]


@pytest.mark.parametrize("kw", PROFILES)
def test_profile_accessors_and_json_match_reference(kw):
    mine, ref = prof.ProgramProfile(**kw), jax_prof.ProgramProfile(**kw)
    assert [f.name for f in dataclasses.fields(mine)] == \
        [f.name for f in dataclasses.fields(ref)]
    assert mine.to_json() == ref.to_json()
    assert mine.summary() == ref.summary()
    assert mine.total_collectives == ref.total_collectives
    for op in prof.COLLECTIVES:
        assert mine.collective_count(op) == ref.collective_count(op)
    assert prof.COLLECTIVES == jax_prof.COLLECTIVES


CONTRACTS = [dict(name="ok", counts={"all-gather": 2, "all-reduce": 0},
                  alias_bytes=0),
             dict(name="rng", counts={"all-gather": (1, 16)}),
             dict(name="bad", counts={"all-gather": (3, 16)}),
             dict(name="bad", counts={"all-reduce": 1}),
             dict(name="alias", alias_bytes=1920)]


@pytest.mark.parametrize("kw", CONTRACTS)
def test_contract_check_and_enforce_match_reference(kw):
    pkw = dict(collectives={"all-gather": {"count": 2, "bytes": 100}},
               alias_bytes=0)
    mine = prof.CollectiveContract(**kw)
    ref = jax_prof.CollectiveContract(**kw)
    got = mine.check(prof.ProgramProfile(**pkw))
    want = ref.check(jax_prof.ProgramProfile(**pkw))
    assert got == want
    if want:
        with pytest.raises(prof.ContractViolation) as e_got:
            mine.enforce(prof.ProgramProfile(**pkw))
        with pytest.raises(jax_prof.ContractViolation) as e_want:
            ref.enforce(jax_prof.ProgramProfile(**pkw))
        assert str(e_got.value) == str(e_want.value)
        assert isinstance(e_got.value, AssertionError)
    else:
        mine.enforce(prof.ProgramProfile(**pkw))
    # an unavailable alias measurement is itself a violation
    if kw.get("alias_bytes") is not None:
        assert any("unavailable" in m for m in
                   mine.check(prof.ProgramProfile(alias_bytes=None)))


@pytest.mark.parametrize("kw", [
    {}, {"mode": "async"}, {"scenario": True},
    {"mesh": "2x2", "mode": "sync"}, {"mesh": "2x2", "scenario": True},
    {"mesh": "2x2", "donated": True, "param_bytes": 1920},
    {"donated": True}, {"donated": True, "param_bytes": 64}])
def test_default_contract_matches_reference(kw):
    if kw.get("mesh") == "2x2":      # only .devices is read
        kw = dict(kw, mesh=types.SimpleNamespace(
            devices=np.empty((2, 2), dtype=object)))
    mine, ref = prof.default_contract(**kw), jax_prof.default_contract(**kw)
    assert (mine.name, dict(mine.counts), mine.alias_bytes) == \
        (ref.name, dict(ref.counts), ref.alias_bytes)
    assert prof.DEFAULT_GATHER_RANGE == jax_prof.DEFAULT_GATHER_RANGE
    assert prof.SCENARIO_REDUCE_RANGE == jax_prof.SCENARIO_REDUCE_RANGE


def test_param_tree_bytes_matches_reference():
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((4, 59)).astype(np.float32),
            "b": np.zeros((3,), np.int32),
            "h": [np.zeros((2, 5), np.float16), np.zeros((7,), np.int64)]}
    want = jax_prof.param_tree_bytes(tree)
    assert want == 4 * 59 * 4 + 3 * 4 + 2 * 5 * 2 + 7 * 8
    assert prof.param_tree_bytes(tree) == want
    as_torch = {"w": torch.from_numpy(tree["w"]),
                "b": torch.from_numpy(tree["b"]),
                "h": [torch.from_numpy(a) for a in tree["h"]]}
    assert prof.param_tree_bytes(as_torch) == want


# -- live extraction ------------------------------------------------------------


def test_profile_jit_on_a_program_takes_no_draw(svm):
    """A sync program's profile on the CPU: its buffers' bytes, the SVM
    step's matmul flops, no collectives, nothing aliased, the memory
    fields the allocator cannot give ``None`` with the reason; the run
    after it is the run without it, bit for bit."""
    ex = svm["executor"]
    cfg = _cfg(svm, "sync", budget=600.0)
    progs = [ingraph.make_sync_program(
        svm["model"], ex.edge_data, ex.eval_set, cfg, lr=ex.lr,
        batch=ex.batch, n_samples=svm["n_samples"], max_rounds=16,
        device="cpu") for _ in range(2)]
    knobs = ingraph.sync_knobs(cfg)
    p = prof.profile_jit(progs[0], svm["init_params"], knobs)
    assert p.backend == "cpu" and not p.donated
    assert p.collectives == {} and p.collective_bytes == 0
    assert p.total_collectives == 0 and p.alias_bytes == 0
    assert p.hlo_lines is None and p.flops > 0
    assert p.argument_bytes >= prof.param_tree_bytes(svm["init_params"])
    assert p.output_bytes > prof.param_tree_bytes(svm["init_params"])
    assert p.temp_bytes is None and p.peak_live_bytes is None
    assert any(e.startswith("memory:") for e in p.errors)
    outs = [prog(svm["init_params"], knobs,
                 TorchDraws(torch.Generator().manual_seed(17)))
            for prog in progs]
    for k, v in outs[1][1].items():
        np.testing.assert_array_equal(outs[0][1][k], v, err_msg=k)
    for k, v in outs[1][0].items():
        assert torch.equal(outs[0][0][k], v), k
    prof.default_contract(param_bytes=prof.param_tree_bytes(
        svm["init_params"])).enforce(p)


# -- session wiring: profiles attach, cache once, contracts gate ----------------


def test_session_sync_profile_attaches_and_caches_once(svm):
    s = _session(svm, _cfg(svm, "sync", budget=600.0))
    rep = s.run_sync_ingraph(max_rounds=16, profile=True, contract=True)
    p = rep.telemetry["profile"]
    assert set(p) == {f.name for f in dataclasses.fields(
        jax_prof.ProgramProfile)}
    assert p["collectives"] == {}        # 1 device: no collectives
    assert p["alias_bytes"] == 0         # nothing donated
    assert p["donated"] is False
    assert s.compile_cache.stats()["profiled"] == 1
    # the second dispatch reuses the stored profile
    rep2 = s.run_sync_ingraph(max_rounds=16, profile=True)
    assert rep2.telemetry["profile"] == p
    assert s.compile_cache.stats()["profiled"] == 1
    assert [r.interval for r in rep2.records] == \
        [r.interval for r in rep.records]
    # profiling stays opt-in: an unprofiled run carries no profile key
    rep3 = _session(svm, _cfg(svm, "sync", budget=600.0)).run_sync_ingraph(
        max_rounds=16)
    assert "profile" not in rep3.telemetry
    assert "device_loop" in rep3.telemetry and "cache" in rep3.telemetry
    assert [r.interval for r in rep3.records] == \
        [r.interval for r in rep.records]
    # clear() drops the profiles with the programs
    s.clear_compile_cache()
    assert s.compile_cache.stats()["profiled"] == 0


def test_session_async_profile_attaches(svm):
    s = _session(svm, _cfg(svm, "async", budget=600.0))
    rep = s.run_async_ingraph(max_events=32, profile=True, contract=True)
    p = rep.telemetry["profile"]
    assert p["collectives"] == {} and p["alias_bytes"] == 0
    assert rep.telemetry["device_loop"]["batch_k"] == 1


def test_session_contract_violation_raises_before_results_leak(svm):
    s = _session(svm, _cfg(svm, "sync", budget=600.0))
    seen = []
    s.on_round(seen.append)
    impossible = prof.CollectiveContract(
        "impossible", counts={"all-gather": (5, 99)})
    with pytest.raises(prof.ContractViolation, match="impossible"):
        s.run_sync_ingraph(max_rounds=16, contract=impossible)
    assert seen == [] and s._fastpath.last_run == {}   # nothing ran


def test_environment_arms_profiles_and_contracts(svm, monkeypatch):
    monkeypatch.setenv("REPRO_EL_PROFILE", "1")
    rep = _session(svm, _cfg(svm, "sync", budget=600.0)).run_sync_ingraph(
        max_rounds=16)
    assert rep.telemetry["profile"]["alias_bytes"] == 0
    monkeypatch.delenv("REPRO_EL_PROFILE")
    monkeypatch.setenv("REPRO_EL_CONTRACTS", "1")
    rep = _session(svm, _cfg(svm, "async", budget=600.0)).run_async_ingraph(
        max_events=32)
    assert rep.telemetry["profile"]["collectives"] == {}


# -- fleet wiring: cohort profiles land on tenant reports -----------------------


def test_fleet_profile_attaches_to_tenant_reports(svm):
    server = FleetServer(n_slots=2, rounds_per_wave=4, profile=True,
                         device="cpu")
    for s, b in enumerate((600.0, 900.0)):
        server.submit(TenantRun(cfg=_cfg(svm, "sync", budget=b, seed=s),
                                executor=svm["executor"],
                                tenant_id=f"t{s}",
                                metric_name=svm["metric"],
                                n_samples=svm["n_samples"],
                                init_params=svm["init_params"],
                                max_rounds=16))
    reports = server.drain()
    cohort, = server.cohorts()
    assert server._cache.profile(cohort.key) is cohort._profile
    assert server._cache.stats()["profiled"] == 1
    server.close()
    assert len(reports) == 2
    profiles = [rep.telemetry["profile"] for rep in reports.values()]
    assert profiles[0] == profiles[1]
    p = profiles[0]
    # the cohort's wave updates its stacked carry in place
    assert p["donated"] is True
    assert 0 < p["alias_bytes"] < p["argument_bytes"]
    assert p["collectives"] == {} and p["flops"] > 0
    assert [e.split(":")[0] for e in p["errors"]] == ["memory"]

"""The port's ``CellBatch`` (``repro_torch.el.sweep.engine``): the sweep's
vmapped cell stepped a wave at a time over slots, on the CPU.

Tenants are admitted into free slots and harvested between waves; each
tenant draws from its own ``ReplayDraws`` of ``jax.random.key(seed +
17)`` (the solo parity tests' helpers).  Every harvested tenant must
equal, field for field and bit for bit, the port's solo program on the
same draws, and make the decisions of the reference's solo
``run_sync_ingraph`` / ``run_async_ingraph`` (intervals, event edges,
arm pulls, rounds; ``consumed`` bit-equal at fixed cost).  The
reference's own fleet is not the yardstick: its refill tests fail on
this tree (ROADMAP Queue 3).
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_events import jax_event_draws  # noqa: E402
from test_torch_ingraph import jax_round_draws  # noqa: E402

from repro.el import ELSession as JaxSession  # noqa: E402
from repro.launch.classic import classic_fixture as jax_fixture  # noqa: E402
from repro_torch.el import events, ingraph  # noqa: E402
from repro_torch.el.rng import ReplayDraws  # noqa: E402
from repro_torch.el.sweep import make_cell_batch  # noqa: E402
from repro_torch.interop import params_from_numpy, tree_map  # noqa: E402
from repro_torch.launch.classic import classic_fixture  # noqa: E402

SAMPLES, EDGES, SLOTS = 1500, 3, 3
# five tenants through three slots: two wait for a slot to free up
TENANTS = [dict(ucb_c=1.0, budget=900.0, seed=0),
           dict(ucb_c=2.0, budget=1300.0, seed=3),
           dict(ucb_c=0.5, budget=700.0, seed=1),
           dict(ucb_c=2.0, budget=1100.0, seed=2),
           dict(ucb_c=1.0, budget=1000.0, seed=4)]

pytestmark = pytest.mark.filterwarnings("error:.*performance drop")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The device loops are hundreds of small ops a step; on a CPU that
    other test processes load, torch's OpenMP pool spin-waits between them
    (a case took 112 s under load with the default pool, 19 s with one
    thread).  One intra-op thread for this module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixtures():
    return {arch: (jax_fixture(arch, samples=SAMPLES, n_edges=EDGES),
                   classic_fixture(arch, samples=SAMPLES, n_edges=EDGES,
                                   device="cpu"))
            for arch in ("svm-wafer", "kmeans-traffic")}


def _base(fx, mode):
    return dataclasses.replace(fx["exp"].ol4el, mode=mode, n_edges=EDGES,
                               utility=fx["utility"], heterogeneity=2.0,
                               async_batch_k=2 if mode == "async" else 0)


def _knobs(cfg):
    return (ingraph.sync_knobs(cfg) if cfg.mode == "sync"
            else events.async_knobs(cfg))


def _draws(cfg, batch, horizon):
    if cfg.mode == "sync":
        return ReplayDraws(*jax_round_draws(
            cfg.seed + 17, horizon, cfg.max_interval, EDGES,
            cfg.max_interval, batch))
    return jax_event_draws(cfg.seed + 17, horizon, EDGES, cfg.max_interval,
                           cfg.max_interval, batch)


def _setup(fixtures, arch, mode, rounds_per_wave=4):
    jf, tf = fixtures[arch]
    base = _base(tf, mode)
    tenants = [dataclasses.replace(base, **t) for t in TENANTS]
    horizon = 64 if mode == "sync" else events.padded_event_horizon(
        max(tenants, key=lambda c: c.budget))
    ex = tf["executor"]
    cb = make_cell_batch(ex.model, ex.edge_data, ex.eval_set, base,
                         n_slots=SLOTS, rounds_per_wave=rounds_per_wave,
                         lr=ex.lr, batch=ex.batch,
                         n_samples=tf["n_samples"], horizon=horizon,
                         device="cpu")
    init = params_from_numpy(jax.tree.map(np.asarray, jf["init_params"]),
                             "cpu")
    return jf, tf, tenants, horizon, cb, init


def _stack(rows):
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def _run_fleet(cb, tenants, init, batch, horizon):
    """Admit tenants into free slots (``place_many`` padded to the slot
    count by repetition), step a wave, harvest the finished; returns
    each tenant's ``(params, out)`` and the waves it took."""
    queue = list(range(len(tenants)))
    occupant = [None] * cb.n_slots
    rows = [_knobs(tenants[0])] * cb.n_slots
    stacked, done, waves = None, {}, 0
    while queue or any(o is not None for o in occupant):
        free = [s for s in range(cb.n_slots) if occupant[s] is None]
        admit = list(zip(free, queue))
        queue = queue[len(admit):]
        if admit:
            carries, slots, draws = [], [], []
            for slot, i in admit:
                d = _draws(tenants[i], batch, horizon)
                carries.append(cb.init_slot(init, _knobs(tenants[i]), d))
                slots.append(slot)
                draws.append(d)
                occupant[slot], rows[slot] = i, _knobs(tenants[i])
            if stacked is None:
                stacked = cb.broadcast(carries[0])
            pad = cb.n_slots - len(slots)
            stacked = cb.place_many(stacked, carries + carries[-1:] * pad,
                                    slots + slots[-1:] * pad,
                                    draws + draws[-1:] * pad)
        active = torch.tensor([o is not None for o in occupant])
        stacked, running = cb.step(stacked, _stack(rows), active)
        waves += 1
        for slot, i in enumerate(occupant):
            if i is not None and not bool(running[slot]):
                params, out = cb.finalize_slot(cb.take_slot(stacked, slot),
                                               rows[slot])
                done[i] = (params, out, waves)
                occupant[slot] = None
        assert waves < 200
    return done


def _solo(tf, cfg, horizon, init, draws):
    ex = tf["executor"]
    if cfg.mode == "sync":
        prog = ingraph.make_sync_program(
            ex.model, ex.edge_data, ex.eval_set, cfg, lr=ex.lr,
            batch=ex.batch, n_samples=tf["n_samples"], max_rounds=horizon,
            device="cpu")
    else:
        prog = events.make_async_program(
            ex.model, ex.edge_data, ex.eval_set, cfg, lr=ex.lr,
            batch=ex.batch, max_events=horizon, device="cpu")
    return prog(init, _knobs(cfg), draws)


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


@pytest.mark.parametrize("arch", ["svm-wafer", "kmeans-traffic"])
@pytest.mark.parametrize("mode", ["sync", "async"])
def test_tenants_through_slots_equal_their_solo_runs(fixtures, arch, mode):
    jf, tf, tenants, horizon, cb, init = _setup(fixtures, arch, mode)
    batch = tf["executor"].batch
    done = _run_fleet(cb, tenants, init, batch, horizon)
    assert sorted(done) == list(range(len(tenants)))
    # the last two tenants waited for a slot: admitted mid-flight
    assert len({w for _, _, w in done.values()}) > 1
    # one reference session: a tenant's knobs reuse its compiled program
    jsess = (JaxSession(_base(jf, mode), metric_name=jf["metric"],
                        lr=jf["lr"])
             .with_executor(jf["executor"], init_params=jf["init_params"],
                            n_samples=jf["n_samples"]))
    for i, cfg in enumerate(tenants):
        params, out, _ = done[i]
        solo_params, solo = _solo(tf, cfg, horizon, init,
                                  _draws(cfg, batch, horizon))
        assert out.keys() == solo.keys()
        for k in solo:
            assert _same_bits(out[k], solo[k]), (i, k)
        for k in solo_params:
            assert torch.equal(params[k], solo_params[k]), (i, k)
        # the reference's solo run on the same jax.random stream
        jsess.cfg = dataclasses.replace(_base(jf, mode), **TENANTS[i])
        ref = (jsess.run_sync_ingraph(max_rounds=horizon) if mode == "sync"
               else jsess.run_async_ingraph())
        n = int(out["n_rounds"])
        assert n == ref.n_aggregations > 3
        assert out["interval"][:n].tolist() == \
            [r.interval for r in ref.records]
        assert out["consumed"][:n].tolist() == \
            [r.total_consumed for r in ref.records]
        pulls = out["arm_pulls"] if mode == "sync" else \
            out["arm_pulls"].sum(0)
        assert pulls.tolist() == ref.arm_pulls
        if mode == "async":
            assert out["edge"][:n].tolist() == [r.edge for r in ref.records]
            assert int(out["n_active"]) == 0


def _bits(tree):
    return {k: v.view(torch.int32) if v.dtype == torch.float32 else v
            for k, v in _flat(tree).items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_an_inactive_slot_is_left_byte_for_byte(fixtures, mode):
    _, tf, tenants, horizon, cb, init = _setup(fixtures, "svm-wafer", mode,
                                               rounds_per_wave=2)
    batch = tf["executor"].batch
    draws = [_draws(c, batch, horizon) for c in tenants[:SLOTS]]
    carries = [cb.init_slot(init, _knobs(c), d)
               for c, d in zip(tenants, draws)]
    stacked = cb.broadcast(carries[0])
    for slot, (c, d) in enumerate(zip(carries, draws)):
        stacked = cb.place(stacked, c, slot, d)
    knobs = _stack([_knobs(c) for c in tenants[:SLOTS]])
    stacked, running = cb.step(stacked, knobs, torch.ones(SLOTS,
                                                          dtype=torch.bool))
    assert bool(running.all())
    before = {k: v.clone() for k, v in _bits(cb.take_slot(stacked,
                                                          1)).items()}
    t_others = stacked["t"].clone()
    stacked, running = cb.step(stacked, knobs,
                               torch.tensor([True, False, True]))
    assert not bool(running[1]) and bool(running[0])
    after = _bits(cb.take_slot(stacked, 1))
    for k, v in before.items():
        assert torch.equal(v, after[k]), k
    assert int(stacked["t"][0]) > int(t_others[0])
    assert int(stacked["t"][2]) > int(t_others[2])


def test_place_many_with_padded_duplicates_equals_single_places(fixtures):
    _, tf, tenants, horizon, cb, init = _setup(fixtures, "kmeans-traffic",
                                               "async")
    batch = tf["executor"].batch
    draws = [_draws(c, batch, horizon) for c in tenants[:2]]
    carries = [cb.init_slot(init, _knobs(c), d)
               for c, d in zip(tenants, draws)]
    a = cb.broadcast(carries[0])
    a = cb.place(a, carries[0], 0, draws[0])
    a = cb.place(a, carries[1], 2, draws[1])
    b = cb.broadcast(carries[0])
    b = cb.place_many(b, [carries[0], carries[1], carries[1]], [0, 2, 2],
                      [draws[0], draws[1], draws[1]])
    for k, v in _bits(a).items():
        assert torch.equal(v, _bits(b)[k]), k
    assert cb.draws.providers[2] is draws[1]
    rows = _bits(cb.take_many(b, [2, 0]))
    for k, v in _bits(carries[1]).items():
        assert torch.equal(rows[k][0], v), k
    one = _bits(cb.take_slot(b, 0))
    for k, v in _bits(carries[0]).items():
        assert torch.equal(one[k], v), k


def test_cell_batch_rejects_what_it_does_not_port(fixtures):
    _, tf = fixtures["svm-wafer"]
    ex = tf["executor"]
    from repro_torch.launch.mesh import PlanMesh
    for kw, item in (({"mesh": PlanMesh(2)}, "item 14"),
                     ({"telemetry": True}, "item 12")):
        if item == "item 14":
            # over a mesh (a plan's: rank 0 of 2 data ranks) a batch holds
            # its block of the slots and writes only the slots it owns;
            # 3 slots do not tile 2 ranks: replicated, and said so (the
            # 2- and 4-rank cohorts are tests/test_torch_mesh_events.py's)
            cb = make_cell_batch(ex.model, ex.edge_data, ex.eval_set,
                                 _base(tf, "sync"), n_slots=4, lr=ex.lr,
                                 batch=ex.batch, device="cpu", **kw)
            assert (cb.n_slots, cb.n_local, cb.shard.rows) == (4, 2,
                                                          slice(0, 2))
            carry = cb.init_slot(tf["init_params"],
                                 _knobs(_base(tf, "sync")), None)
            zero = tree_map(torch.zeros_like, carry)
            st = cb.place_many(cb.broadcast(zero), [carry, carry], [1, 3],
                               [None, None])
            assert torch.equal(st["params"]["w"][1], carry["params"]["w"])
            assert torch.equal(st["params"]["w"][0], zero["params"]["w"])
            assert st["params"]["w"].shape[0] == 2
            with pytest.warns(UserWarning, match="do not tile"):
                rep = make_cell_batch(
                    ex.model, ex.edge_data, ex.eval_set, _base(tf, "sync"),
                    n_slots=3, lr=ex.lr, batch=ex.batch, device="cpu", **kw)
            assert rep.shard is None and rep.n_local == rep.n_slots == 3
            continue
        # the rings are ported: a slot's initial carry has empty rings
        cb = make_cell_batch(ex.model, ex.edge_data, ex.eval_set,
                             _base(tf, "sync"), n_slots=2, lr=ex.lr,
                             batch=ex.batch, device="cpu", **kw)
        carry = cb.init_slot(tf["init_params"], _knobs(_base(tf, "sync")),
                             None)
        assert (carry["telem"]["arm"] == -1).all()
        assert carry["telem"]["arm"].shape == (128,)

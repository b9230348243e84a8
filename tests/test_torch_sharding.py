"""The port's placement policy (``repro_torch.sharding``) and OL4EL round
over edges (``repro_torch.federated.local_sgd``) vs the reference's, on
the CPU.

Specs: every function of ``repro.sharding`` is held spec for spec (equal
``PartitionSpec`` s at equal key paths) on a duck-typed mesh
(``axis_names`` and ``devices = np.empty(shape)``) that both packages
read, over every ``ARCH_IDS`` parameter tree (the port's meta
``LM.init(None)`` against the reference's ``jax.eval_shape``), with
``fsdp`` on and off, caches at batch 1 and 128, on the axis sizes of
(16, 16), (2, 16, 16), 2 x 2 and 4 x 2.

``local_sgd``: qwen3's smoke config at f32, the reference's initial
state carried across by ``interop``, numpy tokens and the reference's
``jax_select_arm`` draws replayed through the RNG seam: ``make_el_round``
(sync and async) and ``make_el_program`` give the reference's losses
within ``LOSS_TOL`` and parameters within ``PARAM_TOL`` (SGD, whose
update is linear in the gradient: the reference's parameters to
1e-5 in ``tests/test_torch_train.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

torch = pytest.importorskip("torch")

from repro import config as ref_config  # noqa: E402
from repro import sharding as ref_sharding  # noqa: E402
from repro.core import bandit as ref_bandit  # noqa: E402
from repro.federated import local_sgd as ref_local_sgd  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro_torch import config as port_config  # noqa: E402
from repro_torch import sharding  # noqa: E402
from repro_torch.el.rng import ReplayDraws  # noqa: E402
from repro_torch.federated import local_sgd  # noqa: E402
from repro_torch.interop import tree_from_numpy, tree_leaves  # noqa: E402
from repro_torch.models import LM  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "4x2": ((4, 2), ("data", "model"))}
LOSS_TOL = 1e-5
PARAM_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class DuckMesh:
    """What both packages' resolvers read of a mesh."""

    def __init__(self, name):
        shape, self.axis_names = MESHES[name]
        self.devices = np.empty(shape)


def _jax_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    out = {}
    for path, leaf in flat:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", getattr(
            k, "name", k)))) for k in path)
        out[key] = leaf
    return out


def _port_flat(tree, prefix=""):
    if isinstance(tree, sharding.PartitionSpec) or not isinstance(
            tree, (dict, list, tuple)):
        return {prefix: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_port_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _assert_same_specs(got, want):
    got, want = _port_flat(got), _jax_flat(want)
    assert got.keys() == want.keys()
    for k in want:
        assert isinstance(got[k], sharding.PartitionSpec), k
        assert tuple(got[k]) == tuple(want[k]), (k, got[k], want[k])


@pytest.fixture(scope="module")
def trees():
    """Per arch: (port cfg, ref cfg, port meta params, ref eval_shape
    params, caches at batch 1 and 128 of both)."""
    out = {}
    for arch in port_config.ARCH_IDS:
        pc = port_config.get_config(arch).model
        rc = ref_config.get_config(arch).model
        model, ref = LM(pc, device="meta"), ref_build(rc)
        caches = {b: (model.init_cache(b, 1024),
                      jax.eval_shape(lambda b=b: ref.init_cache(b, 1024)))
                  for b in (1, 128)}
        out[arch] = (pc, rc, model.init(None),
                     jax.eval_shape(ref.init, jax.random.key(0)), caches)
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("fsdp", [False, True])
def test_param_specs_are_the_references_for_every_arch(trees, mesh, fsdp):
    m = DuckMesh(mesh)
    for arch, (pc, rc, tree, ref_tree, _) in trees.items():
        _assert_same_specs(sharding.param_specs(pc, m, tree, fsdp=fsdp),
                           ref_sharding.param_specs(rc, m, ref_tree,
                                                    fsdp=fsdp))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("batch", [1, 128])
def test_cache_specs_are_the_references_for_every_arch(trees, mesh, batch):
    m = DuckMesh(mesh)
    for arch, (pc, rc, _, _, caches) in trees.items():
        got, want = caches[batch]
        _assert_same_specs(sharding.cache_specs(pc, m, got, batch),
                           ref_sharding.cache_specs(rc, m, want, batch))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_specs_are_the_references(mesh):
    from repro.launch import specs as ref_specs
    from repro_torch.launch import specs
    m = DuckMesh(mesh)
    assert tuple(sharding.batch_spec(m)) == tuple(ref_sharding.batch_spec(m))
    for arch in ("qwen3-1.7b", "musicgen-medium", "paligemma-3b"):
        pc = port_config.get_config(arch).model
        rc = ref_config.get_config(arch).model
        for batch in (1, 6, 128):
            for shard in (True, False):
                _assert_same_specs(
                    sharding.batch_sharding(
                        pc, m, specs.batch_struct(pc, batch, 64), shard),
                    ref_sharding.batch_sharding(
                        rc, m, ref_specs.batch_struct(rc, batch, 64), shard))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 32])
def test_el_placement_policy_is_the_references(mesh, n):
    """The edge / slot dims' tiles-or-replicates rule, the run's knob
    specs, the stacked classic param specs, a cohort's state specs and
    the in-shardings' specs."""
    m = DuckMesh(mesh)
    sizes = dict(zip(m.axis_names, m.devices.shape))
    assert sharding.el_edge_dim_axes(m.axis_names, sizes, n) == \
        ref_sharding.el_edge_dim_axes(m.axis_names, sizes, n)
    assert sharding.el_cohort_slot_axes(m.axis_names, sizes, n) == \
        ref_sharding.el_cohort_slot_axes(m.axis_names, sizes, n)
    knobs = sharding.EL_SCALAR_KNOBS + sharding.EL_EDGE_KNOBS
    got = sharding.el_run_partition_specs(m.axis_names, sizes, n, knobs)
    want = ref_sharding.el_run_partition_specs(m.axis_names, sizes, n, knobs)
    assert tuple(got[0]) == tuple(want[0])
    assert {k: tuple(v) for k, v in got[1].items()} == \
        {k: tuple(v) for k, v in want[1].items()}
    for arch in ("svm-wafer", "kmeans-traffic"):
        model = ref_build(ref_config.get_config(arch).model)
        p = jax.eval_shape(model.init, jax.random.key(0))
        stacked = {k: jax.ShapeDtypeStruct((n,) + v.shape, v.dtype)
                   for k, v in p.items()}
        port = {k: torch.empty(v.shape, device="meta")
                for k, v in stacked.items()}
        _assert_same_specs(sharding.el_stacked_param_specs(m, n, port),
                           ref_sharding.el_stacked_param_specs(m, n, stacked))
        state = {"carry": port, "t": torch.empty((n,), device="meta"),
                 "scalar": torch.empty((), device="meta")}
        ref_state = {"carry": stacked,
                     "t": jax.ShapeDtypeStruct((n,), jnp.int32),
                     "scalar": jax.ShapeDtypeStruct((), jnp.float32)}
        _assert_same_specs(sharding.el_cohort_state_specs(m, n, state),
                           ref_sharding.el_cohort_state_specs(m, n,
                                                              ref_state))
    assert sharding.EL_EDGE_KNOBS == ref_sharding.EL_EDGE_KNOBS
    assert sharding.EL_SCALAR_KNOBS == ref_sharding.EL_SCALAR_KNOBS
    assert sharding.EL_SCHEDULE_KNOBS == ref_sharding.EL_SCHEDULE_KNOBS


def test_in_shardings_and_placements():
    """``el_run_in_shardings``' placements carry the reference's
    ``NamedSharding`` specs, and a placement's blocks tile a tensor over
    the ranks of a 2 x 2 mesh (pod x data flattened on a 2 x 2 x 1)."""
    m = DuckMesh("2x2")
    m.devices = np.arange(4).reshape(2, 2)
    pc = port_config.get_smoke_config("qwen3-1.7b").model
    tree = LM(pc, device="meta").init(None)
    p_sh, rep, knobs = sharding.el_run_in_shardings(m, pc, tree, ("budget",))
    want = sharding.param_specs(pc, m, tree)
    flat = _port_flat(p_sh)
    assert all(isinstance(v, sharding.Placement) for v in flat.values())
    assert {k: v.spec for k, v in flat.items()} == _port_flat(want)
    assert rep.replicated and knobs["budget"].replicated
    classic = sharding.el_run_in_shardings(m, None, {"w": torch.empty(3)},
                                           ())[0]
    assert classic["w"].replicated
    edge = sharding.Placement(m, sharding.P("data", None))
    blocks = [edge.local_slices((6, 5), r) for r in range(4)]
    assert [b[0] for b in blocks] == [slice(0, 3), slice(0, 3),
                                      slice(3, 6), slice(3, 6)]
    m3 = DuckMesh("2x16x16")
    m3.devices = np.arange(8).reshape(2, 2, 2)
    m3.axis_names = ("pod", "data", "model")
    pd = sharding.Placement(m3, sharding.P(("pod", "data")))
    assert [pd.local_slices((8,), r)[0].start for r in range(8)] == \
        [0, 0, 2, 2, 4, 4, 6, 6]
    with pytest.raises(ValueError, match="split"):
        edge.local_slices((5, 5), 0)


def test_partition_spec_normalizes_as_the_reference():
    P = sharding.PartitionSpec
    assert P(("data",), None) == JP(("data",), None) == ("data", None)
    assert P(()) == JP(()) and P(("pod", "data")) == JP(("pod", "data"))
    assert P(None) != P() and repr(P("a")) == "PartitionSpec('a',)"


# -- local_sgd vs the reference -----------------------------------------------------

H_MAX, EDGES, B, S, ROUNDS = 3, 3, 2, 16, 4


def _f32(exp):
    return dataclasses.replace(exp, model=dataclasses.replace(
        exp.model, dtype="float32"))


@pytest.fixture(scope="module")
def lm():
    """qwen3's smoke config at f32 with SGD (momentum 0.9), both packages:
    the reference's model and per-edge initial state, and numpy tokens
    ``[rounds, E, h_max, B, S]``."""
    kw = dict(optimizer="sgd", peak_lr=0.05, momentum=0.9, warmup_steps=2)
    rexp = _f32(ref_config.get_smoke_config("qwen3-1.7b"))
    exp = _f32(port_config.get_smoke_config("qwen3-1.7b"))
    rtc = dataclasses.replace(rexp.train, **kw)
    tc = dataclasses.replace(exp.train, **kw)
    rm = ref_build(rexp.model)
    state = ref_local_sgd.init_el_state(rm, rtc, EDGES, jax.random.key(3))
    tokens = np.random.default_rng(0).integers(
        0, exp.model.vocab_size, (ROUNDS, EDGES, H_MAX, B, S), np.int32)
    return rm, rtc, LM(exp.model, device="cpu"), tc, state, tokens


def _port_state(state):
    np_state = jax.tree.map(np.asarray, state)
    return local_sgd.ELMeshState(
        tree_from_numpy(np_state.params, "cpu"),
        tree_from_numpy(local_sgd.OptState(*np_state.opt), "cpu"))


def _assert_params_close(got, want, tol=PARAM_TOL):
    got_l = [t.numpy() for t in tree_leaves(got)]
    want_l = [np.asarray(a) for a in jax.tree.leaves(want)]
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_el_round_matches_the_reference(lm, mode):
    rm, rtc, tm, tc, state, tokens = lm
    intervals = np.array([1, 3, 2], np.int32)
    weights = np.array([1.0, 2.0, 0.5], np.float32)
    rround = jax.jit(ref_local_sgd.make_el_round(rm, rtc, H_MAX, mode))
    tround = local_sgd.make_el_round(tm, tc, H_MAX, mode)
    rs, ts = state, _port_state(state)
    for r in range(2):
        rs, rmet = rround(rs, {"tokens": jnp.asarray(tokens[r])},
                          jnp.asarray(intervals), jnp.asarray(weights))
        ts, tmet = tround(ts, {"tokens": torch.from_numpy(tokens[r])},
                          torch.from_numpy(intervals),
                          torch.from_numpy(weights))
        np.testing.assert_allclose(float(tmet["mean_loss"]),
                                   float(rmet["mean_loss"]), rtol=LOSS_TOL)
        assert float(tmet["mean_interval"]) == float(rmet["mean_interval"])
        _assert_params_close(ts.params, rs.params)
    np.testing.assert_array_equal(ts.opt.step.numpy(), np.asarray(rs.opt.step))
    _assert_params_close(ts.opt.mu, rs.opt.mu)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_el_program_matches_the_reference(lm, mode):
    """The whole loop on replayed ``jax_select_arm`` draws: each round's
    Gumbel rows are ``gumbel(split(split(rng)[1], E)[e], (h_max,))``, the
    keys ``jax.random.categorical`` draws from."""
    rm, rtc, tm, tc, state, tokens = lm
    comp = np.array([40.0, 60.0, 100.0], np.float32)
    comm = np.full(EDGES, 50.0, np.float32)
    budgets = np.full(EDGES, 400.0, np.float32)
    tok = jnp.asarray(tokens)

    def ref_data(edge_ids, rnd, steps):
        return {"tokens": tok[rnd][edge_ids][:, steps]}

    prog = jax.jit(ref_local_sgd.make_el_program(
        rm, rtc, EDGES, H_MAX, ROUNDS, ref_data, comp, comm, mode=mode,
        ucb_c=1.0))
    bst = jax.vmap(lambda _: ref_bandit.jax_bandit_init(H_MAX))(
        jnp.arange(EDGES))
    rng = jax.random.key(11)
    r_state, r_b, r_budget, r_hist = prog(state, bst, jnp.asarray(budgets),
                                          rng)

    gumbels, key = [], rng
    for _ in range(ROUNDS):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, EDGES)
        gumbels.append(np.stack([np.asarray(jax.random.gumbel(
            k, (H_MAX,), jnp.float32)) for k in keys]))

    def data_fn(edge_ids, rnd, steps):
        return {"tokens": torch.from_numpy(
            tokens[rnd][edge_ids.numpy()][:, steps.numpy()])}

    tprog = local_sgd.make_el_program(tm, tc, EDGES, H_MAX, ROUNDS, data_fn,
                                      comp, comm, mode=mode, ucb_c=1.0)
    t_state, t_b, t_budget, t_hist = tprog(
        _port_state(state), local_sgd.el_bandit_init(EDGES, H_MAX, "cpu"),
        torch.from_numpy(budgets), ReplayDraws(gumbel=np.stack(gumbels)))
    np.testing.assert_array_equal(t_hist["intervals"].numpy(),
                                  np.asarray(r_hist["intervals"]))
    np.testing.assert_array_equal(t_hist["active"].numpy(),
                                  np.asarray(r_hist["active"]))
    assert not np.asarray(r_hist["active"])[-1].all()   # budget ran out
    np.testing.assert_allclose(t_hist["loss"].numpy(),
                               np.asarray(r_hist["loss"]), rtol=LOSS_TOL)
    np.testing.assert_array_equal(t_hist["budgets"].numpy(),
                                  np.asarray(r_hist["budgets"]))
    np.testing.assert_array_equal(t_b["counts"].numpy(),
                                  np.asarray(r_b["counts"]))
    _assert_params_close(t_state.params, r_state.params)


def test_el_state_specs_are_the_references(lm):
    rm, rtc, tm, tc, state, _ = lm
    for name in MESHES:
        m = DuckMesh(name)
        rc = ref_config.get_smoke_config("qwen3-1.7b").model
        pc = port_config.get_smoke_config("qwen3-1.7b").model
        _assert_same_specs(
            local_sgd.el_state_specs(pc, m, _port_state(state)),
            ref_local_sgd.el_state_specs(rc, m, jax.eval_shape(
                lambda: state)))
    sgd0 = dataclasses.replace(tc, momentum=0.0)
    meta = LM(port_config.get_smoke_config("qwen3-1.7b").model,
              device="meta")
    shapes = local_sgd.init_el_state(meta, sgd0, 2, None)
    specs = local_sgd.el_state_specs(pc, DuckMesh("2x2"), shapes)
    assert all(tuple(s) in (("data",),) for s in
               _port_flat(specs.opt.nu).values())


def test_a_model_axis_is_refused_and_init_draws_edge_by_edge(lm):
    """A model axis was refused until item 14 part 6; now a round builds
    on one, and ``init_el_state`` draws every edge in order whatever the
    split: a rank's edges (``edges=``) are the whole state's rows, and its
    blocks over a model axis (``mesh=``) ``shard_el_state``'s cut of
    them, which ``gather_el_state`` would invert."""
    from repro_torch.launch.mesh import PlanMesh
    _, _, tm, tc, _, _ = lm
    assert callable(local_sgd.make_el_round(tm, tc, H_MAX,
                                            mesh=PlanMesh(1, 2)))
    gen = torch.Generator().manual_seed(5)
    whole = local_sgd.init_el_state(tm, tc, 3, gen)
    part = local_sgd.init_el_state(tm, tc, 3,
                                   torch.Generator().manual_seed(5),
                                   edges=range(1, 3))
    for a, b in zip(tree_leaves(whole.params), tree_leaves(part.params)):
        assert torch.equal(a[1:], b)
    assert whole.opt.step.shape == (3,)
    mesh = PlanMesh(1, 2)
    blocks = local_sgd.init_el_state(tm, tc, 3,
                                     torch.Generator().manual_seed(5),
                                     mesh=mesh)
    specs = local_sgd.el_state_specs(tm.cfg, mesh, whole)
    cut = local_sgd.shard_el_state(whole, specs, mesh)
    n_split = 0
    for a, b, w in zip(tree_leaves(blocks), tree_leaves(cut),
                       tree_leaves(whole)):
        assert torch.equal(a, b) and b.is_contiguous()
        n_split += a.shape != w.shape
    assert n_split > 0

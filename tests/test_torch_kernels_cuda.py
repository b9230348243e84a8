"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither jax nor the JAX package, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_kernels_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402,E501
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.kmeans_assign import kernel as km_kernel  # noqa: E402,E501
from repro_torch.kernels.kmeans_assign import ops, ref  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as ssd_ref  # noqa: E402
from repro_torch.models import KMeans  # noqa: E402

pytestmark = pytest.mark.cuda

# the reference's tests/test_kernels.py cases, then the main path's
# local-step minibatch and evaluation-set shapes; then the lane-group
# kernel's branches: D = 59 (not a multiple of its 8 lanes, scalar loads)
# in bf16, N = 1001 (not a multiple of the block's 16 points); D = 300
# (past a lane group's registers: the block-tiled instance); float16 on
# both instances (16-byte and scalar loads)
KM_CASES = [
    (100, 8, 3, "float32"),
    (1000, 64, 3, "float32"),
    (513, 59, 8, "float32"),
    (256, 16, 32, "float32"),
    (300, 64, 3, "bfloat16"),
    (128, 64, 3, "float32"),
    (4000, 64, 3, "float32"),
    (200, 59, 3, "bfloat16"),
    (64, 300, 4, "float32"),
    (1001, 64, 3, "float32"),
    (1000, 64, 3, "float16"),
    (200, 59, 3, "float16"),
    (300, 64, 1000, "float16"),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `PYTHONPATH=src python -m pytest "
                    "--noconftest -m cuda tests/test_torch_kernels_cuda.py` "
                    "on the card")
    return torch.device("cuda")


def _inputs(n, d, k, dtype, seed, device):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((n, d)), dtype=torch.float32)
    c = torch.tensor(rng.standard_normal((k, d)), dtype=torch.float32)
    dt = getattr(torch, dtype)
    return x.to(device, dt), c.to(device, dt)


@pytest.mark.parametrize("n,d,k,dtype", KM_CASES)
def test_kmeans_assign_matches_plain(n, d, k, dtype, cuda_device):
    x, c = _inputs(n, d, k, dtype, n + d + k, cuda_device)
    before = ops.launches
    a, d2 = ops.assign_with_dist(x, c)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert a.dtype == torch.int32 and d2.dtype == torch.float32
    a_ref, d2_ref = ref.assign_ref(x, c)
    rtol, atol = ref.tolerance(x.dtype)
    torch.testing.assert_close(d2, d2_ref, rtol=rtol, atol=atol)
    if dtype == "float32":
        assert float((a == a_ref).float().mean()) >= 0.999


@pytest.mark.parametrize("n,d,k,dtype", [(300, 40, 3, "bfloat16"),
                                         (200, 24, 3, "bfloat16")])
def test_kmeans_assign_lanes_beyond_d(n, d, k, dtype, cuda_device):
    """More lanes per point than a bf16 row has 16-byte vectors (8 lanes
    for 5 at D = 40, 4 for 3 at D = 24): the lanes without a share add
    nothing and still join every shuffle."""
    assert km_kernel.lane_group(d) > d // 8
    x, c = _inputs(n, d, k, dtype, n + d, cuda_device)
    a, d2 = ops.assign_with_dist(x, c)
    torch.cuda.synchronize()
    a_ref, d2_ref = ref.assign_ref(x, c)
    torch.testing.assert_close(d2, d2_ref, rtol=1e-2, atol=1e-2)


def test_kmeans_assign_unaligned_rows_take_scalar_loads(cuda_device):
    """Rows that do not start on 16 bytes (a view one element into its
    storage) are read with scalar loads."""
    x, c = _inputs(129, 64, 3, "float32", 4, cuda_device)
    flat = torch.empty(129 * 64 + 1, device=cuda_device)
    flat[1:] = x.reshape(-1)
    xs = flat[1:].view(129, 64)
    assert xs.is_contiguous() and xs.data_ptr() % 16
    a, d2 = ops.assign_with_dist(xs, c)
    a_ref, d2_ref = ref.assign_ref(x, c)
    torch.cuda.synchronize()
    torch.testing.assert_close(d2, d2_ref, rtol=1e-4, atol=1e-3)
    assert torch.equal(a, a_ref)


def test_kmeans_assign_tie_goes_to_lowest_index(cuda_device):
    x, c = _inputs(1000, 64, 4, "float32", 5, cuda_device)
    c[2] = c[0]
    c[3] = c[1]
    a, _ = ops.assign_with_dist(x, c)
    a_ref, _ = ref.assign_ref(x, c)
    torch.cuda.synchronize()
    assert not bool(((a == 2) | (a == 3)).any())
    assert torch.equal(a, a_ref)


def test_kmeans_assign_empty_input_does_not_launch(cuda_device):
    x, c = _inputs(0, 64, 3, "float32", 0, cuda_device)
    before = ops.launches
    a, d2 = ops.assign_with_dist(x, c)
    assert ops.launches == before and a.shape == (0,) and d2.shape == (0,)


def test_kmeans_assign_rejects_what_the_kernel_cannot_take(cuda_device,
                                                           monkeypatch):
    """Non-contiguous rows.  (Points wider than the old 4,096-feature cap,
    D = 4,097, now run on the block-tiled instance: held to the plain
    version here, which is patched to fail inside the op, the launch
    counted.)"""
    x, c = _inputs(64, 64, 3, "float32", 1, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ops.assign_with_dist(x.T.contiguous().T, c)
    wx, wc = _inputs(8, 4097, 3, "float32", 2, cuda_device)
    plain = ops.assign_ref
    monkeypatch.setattr(ops, "assign_ref", lambda *a: pytest.fail(
        "the plain E-step ran for a CUDA tensor"))
    before = ops.launches
    a, d2 = ops.assign_with_dist(wx, wc)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    a_ref, d2_ref = plain(wx, wc)
    torch.testing.assert_close(d2, d2_ref, rtol=1e-4, atol=1e-3)
    assert torch.equal(a, a_ref)


# (n, d, k, dtype): centre sets larger than one block's shared memory,
# walked in tiles: 1,000 centres of 64 (two tiles of 500; 256 KB of
# centroids), a 1,024-entry codebook at D = 128, bf16, a point of 4,096
# features, and past it 5,000 (f16) and 8,192
KM_TILED = [(1000, 64, 1000, "float32"), (4096, 128, 1024, "float32"),
            (300, 64, 1000, "bfloat16"), (64, 4096, 40, "float32"),
            (100, 5000, 70, "float16"), (200, 8192, 7, "float32")]


@pytest.mark.parametrize("n,d,k,dtype", KM_TILED)
def test_kmeans_assign_centres_beyond_one_block_match_plain(
        n, d, k, dtype, cuda_device, monkeypatch):
    monkeypatch.setattr(ops, "assign_ref", lambda *a: pytest.fail(
        "the plain E-step ran for a CUDA tensor"))
    assert km_kernel.plan(d, k, km_kernel.max_smem(0)).block
    x, c = _inputs(n, d, k, dtype, n + d + k, cuda_device)
    before = ops.launches
    a, d2 = ops.assign_with_dist(x, c)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    a_ref, d2_ref = ref.assign_ref(x, c)
    rtol, atol = ref.tolerance(x.dtype)
    torch.testing.assert_close(d2, d2_ref, rtol=rtol, atol=atol)
    if dtype == "float32":
        assert float((a == a_ref).float().mean()) >= 0.999


def test_kmeans_assign_tie_across_a_tile_boundary(cuda_device):
    """K = 1,024 at D = 128 runs in tiles (the block-tiled instance): the
    last centre of one tile and the first of the next are the same point,
    as are one in the first and one in the last tile; points at them go to
    the lower index, as ``jnp.argmin`` does, in the single and the batched
    entry."""
    n, d, k = 4096, 128, 1024
    tile = km_kernel.plan(d, k, km_kernel.max_smem(0)).tile
    assert tile < k
    x, c = _inputs(n, d, k, "float32", 12, cuda_device)
    c[tile] = c[tile - 1]
    c[k - 1] = c[5]
    x[:64] = c[tile - 1] + 1e-3 * x[:64]
    x[64:128] = c[5] + 1e-3 * x[64:128]
    a, _ = ops.assign_with_dist(x, c)
    ab, _ = ops.assign_with_dist_batched(x[None], c[None])
    a_ref, _ = ref.assign_ref(x, c)
    torch.cuda.synchronize()
    assert bool((a[:64] == tile - 1).all()) and bool((a[64:128] == 5).all())
    assert not bool(((a == tile) | (a == k - 1)).any())
    assert torch.equal(a, a_ref) and torch.equal(ab[0], a)


def test_kmeans_cuda_local_step_matches_plain_step(cuda_device):
    cfg = get_config("kmeans-traffic").model
    cuda_model = KMeans(cfg, impl="cuda", device=cuda_device)
    plain_model = KMeans(cfg, impl="torch", device=cuda_device)
    params = cuda_model.init(torch.Generator().manual_seed(3))
    x, _ = _inputs(128, 64, 1, "float32", 9, cuda_device)
    before = ops.launches
    p_cuda, _ = cuda_model.local_step(params, {"x": x}, 1.0)
    p_plain, _ = plain_model.local_step(params, {"x": x}, 1.0)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    torch.testing.assert_close(p_cuda["centers"], p_plain["centers"],
                               rtol=1e-5, atol=1e-5)


# (E, N, D, K, dtype) of the batched entry: the compiled EL round's local
# step (4 edges of (128, 64, 3)), N not a multiple of the block's points,
# wafer widths (scalar loads), K = 1, bf16, D = 300 (32 lanes, past the 8
# elements a lane keeps)
KM_BATCHED = [(4, 128, 64, 3, "float32"), (3, 1001, 64, 3, "float32"),
              (2, 513, 59, 8, "float32"), (2, 100, 64, 1, "float32"),
              (3, 300, 64, 3, "bfloat16"), (2, 64, 300, 4, "float32")]


def _batched_inputs(e, n, d, k, dtype, seed, device):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((e, n, d)), dtype=torch.float32)
    c = torch.tensor(rng.standard_normal((e, k, d)), dtype=torch.float32)
    dt = getattr(torch, dtype)
    return x.to(device, dt), c.to(device, dt)


@pytest.mark.parametrize("e,n,d,k,dtype", KM_BATCHED)
def test_kmeans_assign_batched_bit_equal_to_single_launches(
        e, n, d, k, dtype, cuda_device):
    """One batched launch computes, bit for bit, what E launches of the
    single entry compute (the same kernel, blockIdx.y the edge)."""
    x, c = _batched_inputs(e, n, d, k, dtype, e + n + d + k, cuda_device)
    before, single = ops.batched_launches, ops.launches
    a, d2 = ops.assign_with_dist_batched(x, c)
    assert ops.batched_launches == before + 1 and ops.launches == single
    assert a.shape == (e, n) and a.dtype == torch.int32
    for i in range(e):
        a_i, d2_i = ops.assign_with_dist(x[i], c[i])
        assert torch.equal(a[i], a_i) and torch.equal(d2[i], d2_i)
    torch.cuda.synchronize()
    a_ref, d2_ref = ref.assign_ref(x, c)
    rtol, atol = (1e-4, 1e-3) if dtype == "float32" else (1e-2, 1e-2)
    torch.testing.assert_close(d2, d2_ref, rtol=rtol, atol=atol)


def test_kmeans_assign_batched_in_a_cuda_graph(cuda_device):
    """Captured once, replayed: each replay recomputes from the inputs'
    new values; capture records a launch (``batched_captured``) and runs
    none, and replays are counted through ``add_replayed``."""
    x, c = _batched_inputs(4, 128, 64, 3, "float32", 11, cuda_device)
    ops.assign_with_dist_batched(x, c)                  # warm-up
    torch.cuda.synchronize()
    launched, captured = ops.batched_launches, ops.batched_captured
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        a, d2 = ops.assign_with_dist_batched(x, c)
    assert ops.batched_captured == captured + 1
    assert ops.batched_launches == launched
    for seed in range(3):
        x2, c2 = _batched_inputs(4, 128, 64, 3, "float32", 20 + seed,
                                 cuda_device)
        x.copy_(x2)
        c.copy_(c2)
        graph.replay()
        ops.add_replayed(1)
        a_eager, d2_eager = ops.assign_with_dist_batched(x, c)
        torch.cuda.synchronize()
        assert torch.equal(a, a_eager) and torch.equal(d2, d2_eager)
    assert ops.batched_launches == launched + 6


def test_kmeans_assign_batched_rejects_what_the_kernel_cannot_take(
        cuda_device, monkeypatch):
    """Non-contiguous rows.  (D = 4,097, past the old cap, now runs on the
    block-tiled instance: one launch for both edges, held to the plain
    version, which is patched to fail inside the op.)"""
    x, c = _batched_inputs(2, 64, 64, 3, "float32", 1, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ops.assign_with_dist_batched(x.transpose(1, 2).contiguous()
                                     .transpose(1, 2), c)
    wx, wc = _batched_inputs(2, 8, 4097, 3, "float32", 2, cuda_device)
    plain = ops.assign_ref
    monkeypatch.setattr(ops, "assign_ref", lambda *a: pytest.fail(
        "the plain E-step ran for a CUDA tensor"))
    before = ops.batched_launches
    a, d2 = ops.assign_with_dist_batched(wx, wc)
    torch.cuda.synchronize()
    assert ops.batched_launches == before + 1
    a_ref, d2_ref = plain(wx, wc)
    torch.testing.assert_close(d2, d2_ref, rtol=1e-4, atol=1e-3)
    assert torch.equal(a, a_ref)


def test_kmeans_assign_batched_walks_centre_tiles(cuda_device):
    """The batched entry over 1,000 centres of 64 an edge (two tiles a
    block): bit-equal to single launches, within the plain version's
    tolerance."""
    x, c = _batched_inputs(3, 300, 64, 1000, "float32", 2, cuda_device)
    a, d2 = ops.assign_with_dist_batched(x, c)
    singles = [ops.assign_with_dist(x[j], c[j]) for j in range(3)]
    a_ref, d2_ref = ref.assign_ref(x, c)
    torch.cuda.synchronize()
    for j, (sa, sd) in enumerate(singles):
        assert torch.equal(a[j], sa) and torch.equal(d2[j], sd)
    torch.testing.assert_close(d2, d2_ref, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("cells", [1, 24])
def test_kmeans_assign_batched_under_vmap_is_one_launch(cells, cuda_device):
    """``torch.func.vmap`` over the batched entry (a sweep's cells): the
    op's vmap rule folds (cell, edge) into one launch of C·E pairs,
    bit-equal to C separate batched launches; nested vmaps fold again,
    and inside a capture the folded launch is recorded once."""
    x, c = _batched_inputs(cells * 4, 128, 64, 3, "float32", cells,
                           cuda_device)
    xv, cv = x.view(cells, 4, 128, 64), c.view(cells, 4, 3, 64)
    before = ops.batched_launches
    a, d2 = torch.func.vmap(ops.assign_with_dist_batched)(xv, cv)
    assert ops.batched_launches == before + 1
    assert a.shape == (cells, 4, 128) and a.dtype == torch.int32
    for i in range(cells):
        a_i, d2_i = ops.assign_with_dist_batched(xv[i], cv[i])
        assert torch.equal(a[i], a_i) and torch.equal(d2[i], d2_i)
    if cells > 1:
        x2, c2 = xv.view(2, cells // 2, 4, 128, 64), \
            cv.view(2, cells // 2, 4, 3, 64)
        before = ops.batched_launches
        a2, d22 = torch.func.vmap(torch.func.vmap(
            ops.assign_with_dist_batched))(x2, c2)
        assert ops.batched_launches == before + 1
        assert torch.equal(a2.reshape(a.shape), a)
        assert torch.equal(d22.reshape(d2.shape), d2)
    torch.cuda.synchronize()
    captured = ops.batched_captured
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        a3, d23 = torch.func.vmap(ops.assign_with_dist_batched)(xv, cv)
    assert ops.batched_captured == captured + 1
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(a3, a) and torch.equal(d23, d2)


def test_kmeans_assign_batched_refuses_more_pairs_than_its_grid(
        cuda_device):
    x = torch.zeros(ops.MAX_EDGES + 1, 1, 8, device=cuda_device)
    c = torch.zeros(ops.MAX_EDGES + 1, 2, 8, device=cuda_device)
    with pytest.raises(ValueError, match="pairs"):
        ops.assign_with_dist_batched(x, c)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_sweep_on_the_card_makes_the_solo_runs_decisions(mode,
                                                         cuda_device):
    """``ELSession.sweep`` on the card (the masked step vmapped over the
    cells, CUDA-graph chunks, one batched kernel launch a K-means local
    step for every (cell, edge) pair), with functorch's per-cell fallback
    warning an error: every cell makes the decisions of a solo run of its
    config on the card's default draws."""
    import dataclasses
    import warnings
    from repro_torch.el import ELSession
    from repro_torch.el.sweep import SweepSpec
    from repro_torch.launch.classic import classic_fixture
    fx = classic_fixture("kmeans-traffic", samples=2000, n_edges=3,
                         device=cuda_device)
    cfg = dataclasses.replace(fx["exp"].ol4el, mode=mode, n_edges=3,
                              budget=1500.0, utility=fx["utility"],
                              heterogeneity=2.0)

    def session(c):
        return ELSession(c, metric_name=fx["metric"], lr=fx["lr"]) \
            .with_executor(fx["executor"], init_params=fx["init_params"],
                           n_samples=fx["n_samples"])

    spec = SweepSpec(ucb_c=(1.0, 2.0), budget=(900.0, 1500.0),
                     seeds=(0, 3), max_rounds=128,
                     async_batch_k=(1, 2) if mode == "async" else ())
    before = ops.batched_launches
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        rep = session(cfg).sweep(spec)
    launched = ops.batched_launches - before
    loops = rep.telemetry["device_loops"]
    for loop in loops:
        assert loop["graphs_captured"] == 1
        assert loop["kernel_launches_per_graph"] == \
            loop["rounds_per_chunk"] * cfg.max_interval
    assert launched == sum(lp["kernel_launches_per_graph"]
                           * (lp["replays"] + 1) for lp in loops)
    assert not rep.truncated().any()
    for i, ccfg in enumerate(spec.cell_cfgs(cfg)):
        ind = (session(ccfg).run_sync_ingraph(max_rounds=128)
               if mode == "sync" else
               session(ccfg).run_async_ingraph(max_events=128))
        n = int(rep.out["n_rounds"][i])
        assert n == ind.n_aggregations > 0
        assert rep.out["interval"][i][:n].tolist() == \
            [r.interval for r in ind.records]
        assert rep.out["consumed"][i][:n].tolist() == \
            [r.total_consumed for r in ind.records]
        assert rep.out["wall"][i][:n].tolist() == \
            [r.wall_time for r in ind.records]
        if mode == "async":
            assert rep.out["edge"][i][:n].tolist() == \
                [r.edge for r in ind.records]
            pulls = rep.out["arm_pulls"][i].sum(0)
        else:
            pulls = rep.out["arm_pulls"][i]
        assert pulls.tolist() == ind.arm_pulls


def test_cell_batch_on_the_card_makes_the_solo_runs_decisions(
        cuda_device):
    """``CellBatch`` on the card: four tenants through three slots, one
    CUDA graph a wave (captured at the first step, the stacked carry its
    static buffer, ``place`` writing into it between waves); each
    harvested tenant makes the decisions of its solo run on the card's
    default draws."""
    import dataclasses
    from repro_torch.el import ELSession
    from repro_torch.el.ingraph import sync_knobs
    from repro_torch.el.rng import TorchDraws
    from repro_torch.el.sweep import make_cell_batch
    from repro_torch.launch.classic import classic_fixture
    fx = classic_fixture("kmeans-traffic", samples=2000, n_edges=3,
                         device=cuda_device)
    ex = fx["executor"]
    base = dataclasses.replace(fx["exp"].ol4el, mode="sync", n_edges=3,
                               utility=fx["utility"], heterogeneity=2.0)
    tenants = [dataclasses.replace(base, budget=b, seed=s, ucb_c=c)
               for b, s, c in ((900.0, 0, 1.0), (1500.0, 3, 2.0),
                               (700.0, 1, 0.5), (1100.0, 2, 2.0))]
    cb = make_cell_batch(ex.model, ex.edge_data, ex.eval_set, base,
                         n_slots=3, rounds_per_wave=4, lr=ex.lr,
                         batch=ex.batch, n_samples=fx["n_samples"],
                         horizon=64, device=cuda_device)

    def draws(c):
        return TorchDraws(torch.Generator(device=cuda_device)
                          .manual_seed(c.seed + 17))

    queue, occupant, rows = list(range(4)), [None] * 3, [None] * 3
    stacked, done = None, {}
    while queue or any(o is not None for o in occupant):
        for slot in range(3):
            if occupant[slot] is None and queue:
                i = queue.pop(0)
                d = draws(tenants[i])
                carry = cb.init_slot(fx["init_params"],
                                     sync_knobs(tenants[i]), d)
                if stacked is None:
                    stacked = cb.broadcast(carry)
                stacked = cb.place(stacked, carry, slot, d)
                occupant[slot], rows[slot] = i, sync_knobs(tenants[i])
        knobs = {k: np.stack([(r if r is not None else rows[0])[k]
                              for r in rows]) for k in rows[0]}
        stacked, running = cb.step(stacked, knobs, torch.tensor(
            [o is not None for o in occupant]))
        for slot, i in enumerate(occupant):
            if i is not None and not bool(running[slot]):
                done[i] = cb.finalize_slot(cb.take_slot(stacked, slot),
                                           rows[slot])[1]
                occupant[slot] = None
    program = cb.program
    assert program.graphs_captured == 1
    assert program.launches_per_graph == 4 * base.max_interval
    for i, cfg in enumerate(tenants):
        solo = ELSession(cfg, metric_name=fx["metric"], lr=fx["lr"]) \
            .with_executor(ex, init_params=fx["init_params"],
                           n_samples=fx["n_samples"]) \
            .run_sync_ingraph(max_rounds=64)
        out, n = done[i], int(done[i]["n_rounds"])
        assert n == solo.n_aggregations > 0
        assert out["interval"][:n].tolist() == \
            [r.interval for r in solo.records]
        assert out["consumed"][:n].tolist() == \
            [r.total_consumed for r in solo.records]
        assert out["arm_pulls"].tolist() == solo.arm_pulls


def test_fleet_on_the_card_equals_the_solo_runs(cuda_device):
    """``FleetServer`` on the card: a kmeans sync cohort and an async
    cohort, five tenants each through three slots (two admitted
    mid-flight), one CUDA graph a cohort; every tenant's report equals its
    solo run on the card's default draws (``seed + 17``) field for field,
    its final parameters bit for bit."""
    import dataclasses
    from repro_torch.el import ELSession, FleetServer, TenantRun
    from repro_torch.launch.classic import classic_fixture
    fx = classic_fixture("kmeans-traffic", samples=2000, n_edges=3,
                         device=cuda_device)
    # the async budgets all pad to one event horizon: one program
    knobs = ((900.0, 0, 1.0), (1300.0, 3, 2.0), (700.0, 1, 0.5),
             (1100.0, 2, 2.0), (1000.0, 4, 1.0))
    cfgs = [dataclasses.replace(fx["exp"].ol4el, mode=mode, n_edges=3,
                                utility=fx["utility"], heterogeneity=2.0,
                                budget=b, seed=s, ucb_c=c)
            for mode in ("sync", "async") for b, s, c in knobs]
    server = FleetServer(n_slots=3, rounds_per_wave=16)
    ids = [server.submit(TenantRun(
        cfg=c, executor=fx["executor"], metric_name=fx["metric"],
        n_samples=fx["n_samples"], init_params=fx["init_params"],
        max_rounds=128)) for c in cfgs]
    reports = server.drain()
    st = server.stats()
    assert st["compiles"] == st["cohorts"] == 2 and len(reports) == 10
    assert 1 <= st["place_dispatches"] <= st["waves"]
    assert all(c.batch.program.graphs_captured == 1
               for c in server.cohorts())
    for tid, cfg in zip(ids, cfgs):
        sess = ELSession(cfg, metric_name=fx["metric"], lr=fx["lr"]) \
            .with_executor(fx["executor"], init_params=fx["init_params"],
                           n_samples=fx["n_samples"]
                           if cfg.mode == "sync" else None)
        solo = (sess.run_sync_ingraph(max_rounds=128) if cfg.mode == "sync"
                else sess.run_async_ingraph())
        got = reports[tid]
        assert got.n_aggregations == solo.n_aggregations > 0
        assert [(r.interval, r.edge, r.total_consumed, r.wall_time)
                for r in got.records] == \
            [(r.interval, r.edge, r.total_consumed, r.wall_time)
             for r in solo.records]
        assert (got.arm_pulls, got.terminated_reason, got.total_consumed,
                got.wall_time, got.final_metric) == \
            (solo.arm_pulls, solo.terminated_reason, solo.total_consumed,
             solo.wall_time, solo.final_metric)
        for k, v in solo.final_params.items():
            assert torch.equal(got.final_params[k], v), (tid, k)
    server.close()


@pytest.mark.parametrize("arch", ["kmeans-traffic", "svm-wafer"])
def test_compiled_round_on_the_card_makes_the_cpu_decisions(arch,
                                                            cuda_device):
    """``run_sync_ingraph`` on the card (CUDA-graph chunks, the batched
    kernel in every K-means local step) against the same program on the
    CPU, on the same replayed draws: identical decisions."""
    import dataclasses
    from repro_torch.el import ELSession
    from repro_torch.el.rng import ReplayDraws
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.launch.classic import classic_fixture
    reports = {}
    for dev in ("cuda", "cpu"):
        fx = classic_fixture(arch, samples=2000, n_edges=3, device=dev)
        cfg = dataclasses.replace(fx["exp"].ol4el, mode="sync", n_edges=3,
                                  budget=3000.0, utility=fx["utility"],
                                  heterogeneity=2.0)
        if dev == "cuda":
            init = params_to_numpy(fx["init_params"])
        rng = np.random.default_rng(0)
        k, batch = cfg.max_interval, fx["executor"].batch
        draws = ReplayDraws(rng.gumbel(size=(128, k)),
                            rng.uniform(size=(128, 3, k, batch)),
                            rng.standard_normal((128, 3)))
        sess = ELSession(cfg, metric_name=fx["metric"], lr=fx["lr"]) \
            .with_executor(fx["executor"],
                           init_params=params_from_numpy(init, dev),
                           n_samples=fx["n_samples"])
        before = ops.batched_launches
        reports[dev] = sess.run_sync_ingraph(max_rounds=128, draws=draws)
        launched = ops.batched_launches - before
        if dev == "cuda":
            loop = reports[dev].telemetry["device_loop"]
            assert loop["graphs_captured"] == 1
            assert loop["replays"] == loop["chunks"] > 0
            if arch == "kmeans-traffic":
                # every local step of every round, masked or not, plus the
                # capture's warm-up chunk
                steps = loop["rounds_per_chunk"] * k
                assert loop["kernel_launches_per_graph"] == steps
                assert launched == steps * (loop["replays"] + 1)
            again = sess.run_sync_ingraph(max_rounds=128, draws=draws)
            assert again.telemetry["device_loop"]["graphs_captured"] == 0
            assert [r.interval for r in again.records] == \
                [r.interval for r in reports[dev].records]
    gpu, cpu = reports["cuda"], reports["cpu"]
    assert [r.interval for r in gpu.records] == \
        [r.interval for r in cpu.records]
    assert gpu.arm_pulls == cpu.arm_pulls
    assert gpu.terminated_reason == cpu.terminated_reason == \
        "budget_exhausted"
    np.testing.assert_allclose([r.total_consumed for r in gpu.records],
                               [r.total_consumed for r in cpu.records],
                               rtol=1e-6)


@pytest.mark.parametrize("arch", ["kmeans-traffic", "svm-wafer"])
@pytest.mark.parametrize("policy", ["ol4el", "task_alloc", "delay_energy"])
def test_scenario_round_on_the_card_makes_the_cpu_decisions(arch, policy,
                                                            cuda_device):
    """The scenario sync round (churn, Pareto straggler spikes, drift) on
    the card against the same program on the CPU, on the same replayed
    draws, under each policy of the switch: identical intervals, active
    edges, arm pulls and end, ``consumed`` / ``wall`` bit-equal, and the
    replay oracle holds the card's output."""
    import dataclasses
    from repro_torch.el import ELSession
    from repro_torch.el.rng import ReplayDraws
    from repro_torch.el.scenarios import (ChurnSpec, CostSpec, ScenarioSpec,
                                          verify_sync_replay)
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.launch.classic import classic_fixture
    scn = ScenarioSpec(churn=ChurnSpec(rate=0.3, period=16),
                       cost=CostSpec(kind="pareto", alpha=2.0, period=8),
                       drift=0.05)
    outs = {}
    for dev in ("cuda", "cpu"):
        fx = classic_fixture(arch, samples=2000, n_edges=3, device=dev)
        cfg = dataclasses.replace(fx["exp"].ol4el, mode="sync", n_edges=3,
                                  budget=3000.0, utility=fx["utility"],
                                  heterogeneity=2.0, policy=policy,
                                  scenario=scn)
        if dev == "cuda":
            init = params_to_numpy(fx["init_params"])
        rng = np.random.default_rng(1)
        k, batch = cfg.max_interval, fx["executor"].batch
        draws = ReplayDraws(rng.gumbel(size=(128, k)),
                            rng.uniform(size=(128, 3, k, batch)),
                            rng.standard_normal((128, 3)))
        rep = (ELSession(cfg, metric_name=fx["metric"], lr=fx["lr"])
               .with_executor(fx["executor"],
                              init_params=params_from_numpy(init, dev),
                              n_samples=fx["n_samples"])
               .run_sync_ingraph(max_rounds=128, draws=draws))
        verify_sync_replay(cfg, rep.raw, 128)
        outs[dev] = rep.raw
    gpu, cpu = outs["cuda"], outs["cpu"]
    n = int(cpu["n_rounds"])
    assert int(gpu["n_rounds"]) == n > 3
    assert cpu["active_edges"][:n].min() < 3
    for name in ("interval", "active_edges", "arm_pulls", "consumed",
                 "wall", "budgets_left"):
        np.testing.assert_array_equal(gpu[name], cpu[name], err_msg=name)


@pytest.mark.parametrize("arch", ["kmeans-traffic", "svm-wafer"])
@pytest.mark.parametrize("batch_k", [1, 3])
def test_async_engine_on_the_card_makes_the_cpu_decisions(arch, batch_k,
                                                          cuda_device):
    """``run_async_ingraph`` on the card (CUDA-graph chunks of masked
    event steps, single events or K-event waves, the batched kernel in
    every K-means local step) against the same program on the CPU, on the
    same replayed draws: the same events in the same order, the same
    intervals, charges and times."""
    import dataclasses
    from repro_torch.el import ELSession
    from repro_torch.el.rng import ReplayDraws
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.launch.classic import classic_fixture
    reports = {}
    for dev in ("cuda", "cpu"):
        fx = classic_fixture(arch, samples=2000, n_edges=3, device=dev)
        cfg = dataclasses.replace(fx["exp"].ol4el, mode="async", n_edges=3,
                                  budget=1500.0, utility=fx["utility"],
                                  heterogeneity=1.0, async_batch_k=batch_k)
        if dev == "cuda":
            init = params_to_numpy(fx["init_params"])
        rng = np.random.default_rng(0)
        k, batch = cfg.max_interval, fx["executor"].batch
        draws = ReplayDraws(rng.gumbel(size=(128, 3, k)),
                            rng.uniform(size=(128, 3, k, batch)),
                            rng.standard_normal((128, 3)),
                            init_gumbel=rng.gumbel(size=(3, k)),
                            init_normal=rng.standard_normal(3))
        sess = ELSession(cfg, metric_name=fx["metric"], lr=fx["lr"]) \
            .with_executor(fx["executor"],
                           init_params=params_from_numpy(init, dev))
        before = ops.batched_launches
        reports[dev] = sess.run_async_ingraph(draws=draws)
        launched = ops.batched_launches - before
        if dev == "cuda":
            loop = reports[dev].telemetry["device_loop"]
            assert loop["graphs_captured"] == 1 and loop["batch_k"] == batch_k
            assert loop["replays"] == loop["chunks"] > 0
            if arch == "kmeans-traffic":
                # every local step of every step, masked or not, plus the
                # capture's warm-up chunk
                steps = loop["rounds_per_chunk"] * k
                assert loop["kernel_launches_per_graph"] == steps
                assert launched == steps * (loop["replays"] + 1)
    gpu, cpu = reports["cuda"], reports["cpu"]
    assert [(r.edge, r.interval, r.wall_time, r.total_consumed)
            for r in gpu.records] == \
        [(r.edge, r.interval, r.wall_time, r.total_consumed)
         for r in cpu.records]
    assert gpu.arm_pulls == cpu.arm_pulls
    assert gpu.terminated_reason == cpu.terminated_reason == \
        "budget_exhausted"


# (b, s, h, p, n, chunk, dtype): the reference's tests/test_kernels.py
# cases, then the main path's prefill shapes (mamba2-370m: 32 heads of 64,
# d_state 128, chunk 128) and ragged chunks (a 100-token prompt gives
# L=100; 40 tokens under the smoke config's chunk 32 pad to 64); then the
# bf16 (tensor-core) instance's branches: P tile P (the serving shape,
# B * H = 160) and P / 2 (B * H <= 66), P = N = 128 (jamba-1.5's head dim
# and d_state) with P tiles of 64 and of 128 (a warp holding 4 state
# items), the mid-flight admission prefill (B = 1, S = 128), 5 chunks;
# last jamba-1.5's serving prefill (128 heads of P = N = 128, B * H = 512,
# P tile 64) in bf16 and in f32 (its kernel-vs-naive fill: 16 heads a
# diagonal block, two carry blocks a head).
SSD_CASES = [
    (2, 128, 4, 32, 16, 32, "float32"),
    (1, 256, 2, 64, 128, 128, "float32"),
    (1, 64, 8, 64, 64, 32, "float32"),
    (2, 128, 2, 128, 128, 64, "float32"),
    (1, 128, 4, 32, 16, 32, "bfloat16"),
    (4, 512, 32, 64, 128, 128, "bfloat16"),
    (4, 512, 32, 64, 128, 128, "float32"),
    (2, 100, 32, 64, 128, 100, "bfloat16"),
    (2, 100, 4, 64, 128, 100, "float32"),
    (3, 64, 4, 32, 16, 32, "float32"),
    (1, 384, 2, 128, 128, 128, "float32"),
    (5, 256, 32, 64, 128, 128, "bfloat16"),
    (2, 256, 8, 128, 128, 128, "bfloat16"),
    (1, 128, 136, 128, 32, 64, "bfloat16"),
    (2, 128, 70, 128, 128, 64, "bfloat16"),
    (1, 128, 32, 64, 128, 128, "bfloat16"),
    (2, 640, 8, 64, 128, 128, "bfloat16"),
    (2, 100, 4, 32, 16, 100, "bfloat16"),
    (4, 512, 128, 128, 128, 128, "bfloat16"),
    (4, 512, 128, 128, 128, 128, "float32"),
    (1, 128, 4, 32, 16, 32, "float16"),
    (4, 512, 32, 64, 128, 128, "float16"),
    (1, 128, 136, 128, 32, 64, "float16"),
    (2, 100, 4, 32, 16, 100, "float16"),
]


def ssd_inputs(b, s, h, p, n, dtype, seed, device):
    """The reference test's recipe, drawn with numpy: x * softplus(dt)
    in ``dtype``, da = dt * A in f32 (A < 0), B and C normal."""
    rng = np.random.default_rng(seed)
    dt_ = getattr(torch, dtype)
    x = torch.tensor(rng.standard_normal((b, s, h, p)), dtype=torch.float32)
    dt = torch.nn.functional.softplus(
        torch.tensor(rng.standard_normal((b, s, h)), dtype=torch.float32))
    a = -torch.exp(0.5 * torch.tensor(rng.standard_normal(h),
                                      dtype=torch.float32))
    bm = torch.tensor(rng.standard_normal((b, s, n)), dtype=torch.float32)
    cm = torch.tensor(rng.standard_normal((b, s, n)), dtype=torch.float32)
    dt = dt.to(dt_).float()
    xs = (x.to(dt_).float() * dt[..., None]).to(dt_)
    return (xs.to(device), (dt * a).to(device), bm.to(device, dt_),
            cm.to(device, dt_))


def assert_ssd_close(y, state, x, da, bm, cm, chunk):
    """Kernel vs plain version, within ``ref.allowed_error`` (the rule
    ``chip_smoke.py`` holds the kernel to as well)."""
    for got, (want, allowed) in zip(
            (y, state), ssd_ref.allowed_error(x, da, bm, cm, chunk)):
        err = (got.double() - want).abs()
        assert bool((err <= allowed).all()), \
            f"off by {float(err.max())}, {int((err > allowed).sum())} beyond"


@pytest.mark.parametrize("b,s,h,p,n,chunk,dtype", SSD_CASES)
def test_ssd_scan_matches_plain(b, s, h, p, n, chunk, dtype, cuda_device):
    x, da, bm, cm = ssd_inputs(b, s, h, p, n, dtype, s * h + p, cuda_device)
    before = ssd_ops.launches
    y, state = ssd_ops.ssd(x, da, bm, cm, chunk)
    torch.cuda.synchronize()
    assert ssd_ops.launches == before + 1
    assert y.dtype == x.dtype and state.dtype == torch.float32
    assert_ssd_close(y, state, x, da, bm, cm, chunk)


def test_ssd_scan_decay_never_overflows(cuda_device):
    """Strongly negative da makes a_cs[i] - a_cs[j] huge above the
    diagonal: the kernel must not form exp there (inf * 0 = NaN)."""
    x, da, bm, cm = ssd_inputs(1, 128, 4, 32, 16, "float32", 3, cuda_device)
    da = da * 200.0
    y, state = ssd_ops.ssd(x, da, bm, cm, 128)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(state).all())
    assert_ssd_close(y, state, x, da, bm, cm, 128)


def test_ssd_scan_bf16_decay_never_overflows(cuda_device):
    x, da, bm, cm = ssd_inputs(2, 256, 4, 64, 128, "bfloat16", 3,
                               cuda_device)
    da = da * 200.0
    y, state = ssd_ops.ssd(x, da, bm, cm, 128)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(state).all())
    assert_ssd_close(y, state, x, da, bm, cm, 128)


@pytest.mark.parametrize("p,n,chunk", [(64, 128, 128), (32, 16, 32),
                                       (128, 128, 100), (128, 32, 64)])
def test_ssd_scan_bf16_smem_plan_matches_the_kernel(p, n, chunk,
                                                    cuda_device):
    lib = ssd_kernel.library()
    for tile in (p // 2, p):
        assert ssd_kernel.smem_bytes(p, n, chunk, torch.bfloat16, tile) == \
            lib.ssd_scan_bf16_smem(tile, n, chunk)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float16"])
def test_ssd_scan_bf16_refuses_what_it_cannot_take(dtype, cuda_device,
                                                   monkeypatch):
    """N past 256 state columns (512, the old refusal's shape) runs as two
    parts of 256, y summed in f32 and rounded once: held to the plain
    version, which is patched to fail inside the op, the launch
    counted."""
    x, da, bm, cm = ssd_inputs(1, 128, 2, 32, 512, dtype, 1, cuda_device)
    plain = ssd_ops.ssd_reference
    monkeypatch.setattr(ssd_ops, "ssd_reference", lambda *a, **k: pytest.fail(
        "the plain SSD ran for a CUDA tensor"))
    before = ssd_ops.launches
    y, state = ssd_ops.ssd(x, da, bm, cm, 64)
    torch.cuda.synchronize()
    assert ssd_ops.launches == before + 1
    monkeypatch.setattr(ssd_ops, "ssd_reference", plain)
    assert y.dtype == x.dtype and state.shape == (1, 2, 32, 512)
    assert_ssd_close(y, state, x, da, bm, cm, 64)


# (b, s, h, p, n, chunk, dtype): shapes the kernel reaches through its
# wrapper's plan: mamba2's public chunk of 256 (two sub-chunks of 128) at
# mamba2-370m's widths in both dtypes, P = 48 (P tile 16, no pad), N = 24
# and P = 40 with N = 24 (padded to multiples of 16), N = 256 in bf16
# (sub-chunks of 64), the f32 (256, 256) block (sub-chunks of 64), a
# chunk of 130 (sub-chunks of 65)
SSD_PLANNED = [(4, 512, 32, 64, 128, 256, "bfloat16"),
               (2, 512, 8, 64, 128, 256, "float32"),
               (2, 256, 8, 48, 128, 128, "bfloat16"),
               (2, 256, 8, 64, 24, 128, "bfloat16"),
               (2, 256, 8, 40, 24, 64, "bfloat16"),
               (2, 256, 4, 64, 256, 128, "bfloat16"),
               (1, 256, 2, 256, 256, 128, "float32"),
               (1, 260, 4, 64, 128, 130, "bfloat16")]


@pytest.mark.parametrize("b,s,h,p,n,chunk,dtype", SSD_PLANNED)
def test_ssd_scan_planned_shapes_match_plain(b, s, h, p, n, chunk, dtype,
                                             cuda_device, monkeypatch):
    x, da, bm, cm = ssd_inputs(b, s, h, p, n, dtype, s * h + p + n,
                               cuda_device)
    plain = ssd_ops.ssd_reference
    monkeypatch.setattr(ssd_ops, "ssd_reference", lambda *a, **k: pytest.fail(
        "the plain SSD ran for a CUDA tensor"))
    before = ssd_ops.launches
    y, state = ssd_ops.ssd(x, da, bm, cm, chunk)
    torch.cuda.synchronize()
    assert ssd_ops.launches == before + 1
    monkeypatch.setattr(ssd_ops, "ssd_reference", plain)
    assert y.shape == x.shape and state.shape == (b, h, p, n)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(state).all())
    assert_ssd_close(y, state, x, da, bm, cm, chunk)


# (b, s, h, p, n, chunk, da scale): the f32 (CUDA-core) instance's two
# kernels: chunk 100 (Lp = 112), a single chunk (nothing carried), 16
# chunks (S = 2048: the carried state), P = N = 128 (two carry blocks a
# head, two x slabs), P = 32 with N = 16, B * H = 1, an all-zero da (every
# decay exactly 1), P and N not multiples of 4 (4-byte copies), N = 256
# (the widest carry block), P = 200 (a ragged last P tile), and 20 heads
# in diagonal blocks of 3 (a last group of 2)
SSD_F32_TILES = [
    (2, 100, 4, 64, 128, 100, 1.0),
    (1, 128, 4, 32, 16, 128, 1.0),
    (1, 2048, 2, 64, 128, 128, 1.0),
    (1, 384, 2, 128, 128, 128, 1.0),
    (3, 64, 4, 32, 16, 32, 1.0),
    (1, 256, 1, 64, 128, 128, 1.0),
    (2, 256, 4, 64, 128, 128, 0.0),
    (1, 90, 2, 30, 18, 45, 1.0),
    (1, 128, 2, 32, 256, 64, 1.0),
    (2, 128, 3, 200, 64, 64, 1.0),
    (4, 512, 20, 64, 128, 128, 1.0),
]


@pytest.mark.parametrize("b,s,h,p,n,chunk,scale", SSD_F32_TILES)
def test_ssd_scan_f32_tiles_match_plain(b, s, h, p, n, chunk, scale,
                                        cuda_device):
    x, da, bm, cm = ssd_inputs(b, s, h, p, n, "float32", s * h + p + n,
                               cuda_device)
    da = da * scale
    before = ssd_ops.launches
    y, state = ssd_ops.ssd(x, da, bm, cm, chunk)
    torch.cuda.synchronize()
    assert ssd_ops.launches == before + 1
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(state).all())
    assert_ssd_close(y, state, x, da, bm, cm, chunk)


@pytest.mark.parametrize("n,chunk", [(128, 128), (16, 32), (18, 45),
                                     (256, 64), (128, 100)])
def test_ssd_scan_f32_smem_plan_matches_the_kernel(n, chunk, cuda_device):
    lib = ssd_kernel.library()
    assert ssd_kernel.f32_diag_smem(n, chunk) == \
        lib.ssd_scan_f32_smem(n, chunk, 0)
    assert ssd_kernel.f32_carry_smem(n, chunk) == \
        lib.ssd_scan_f32_smem(n, chunk, 1)


def test_ssd_scan_rejects_what_the_kernel_cannot_take(cuda_device):
    """A chunk that does not divide S, non-contiguous inputs and da not
    f32.  (A chunk of 256, and the f32 (256, 256) block over the card's
    shared memory at chunk 128, now run as sub-chunks:
    ``test_ssd_scan_planned_shapes_match_plain``; N = 512 runs as two
    parts of 256, here at f32 (256, 512) against the plain version.)"""
    x, da, bm, cm = ssd_inputs(1, 256, 2, 32, 16, "float32", 1, cuda_device)
    with pytest.raises(ValueError, match="chunk"):
        ssd_ops.ssd(x, da, bm, cm, 96)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_ops.ssd(x.transpose(1, 2).contiguous().transpose(1, 2), da, bm,
                    cm, 128)
    with pytest.raises(TypeError, match="da"):
        ssd_ops.ssd(x, da.to(torch.bfloat16), bm, cm, 128)
    assert ssd_kernel.smem_bytes(256, 256, 128, torch.float32) \
        > ssd_kernel.max_smem(0)
    big = ssd_inputs(1, 128, 1, 256, 512, "float32", 2, cuda_device)
    before = ssd_ops.launches
    y, state = ssd_ops.ssd(*big, 128)
    torch.cuda.synchronize()
    assert ssd_ops.launches == before + 1
    assert_ssd_close(y, state, *big, 128)


# (b, s, h, kv, d, window, dtype): the reference's tests/test_kernels.py
# FLASH_CASES, then a ragged S, and the training shape (qwen3-1.7b: 16
# query heads and 8 KV heads of 128, B = 8, S = 512); then every branch of
# the bf16 (tensor-core) instance: D 64, 128 and 256, GQA groups 1, 2 and
# 8, S = 17 and 300 (not multiples of its 64-row tiles) and 512, windows
# of 100 and 64 that start mid-tile; last the main-path shapes of
# musicgen-medium (24 heads of 64, MHA: training at B = 8, a prefill of 4
# slots) and paligemma-3b (8 query heads of 256, 1 KV head: 256 prefix
# embeddings before 512 tokens, and the engine's text prefill); then the
# float16 twin of the tensor-core instance (D 64, 128 and 256, ragged S, a
# window) and the wide instance past D = 256 (320 in f16 with a window,
# 300 in f32 padded to 320, 576 in bf16 with MQA)
FLASH_CASES = [
    (1, 128, 4, 4, 64, 0, "float32"),
    (2, 256, 4, 2, 64, 0, "float32"),
    (1, 256, 8, 1, 64, 0, "float32"),
    (1, 128, 4, 4, 128, 0, "float32"),
    (1, 128, 2, 2, 256, 0, "float32"),
    (2, 256, 4, 2, 64, 128, "float32"),
    (1, 256, 4, 4, 64, 64, "float32"),
    (1, 128, 4, 2, 64, 0, "bfloat16"),
    (2, 300, 4, 2, 128, 0, "float32"),
    (2, 300, 4, 2, 64, 100, "bfloat16"),
    (8, 512, 16, 8, 128, 0, "float32"),
    (8, 512, 16, 8, 128, 0, "bfloat16"),
    (1, 17, 4, 4, 64, 0, "bfloat16"),
    (2, 17, 16, 2, 128, 0, "bfloat16"),
    (1, 17, 2, 1, 256, 0, "bfloat16"),
    (2, 300, 16, 2, 128, 0, "bfloat16"),
    (1, 300, 4, 2, 256, 0, "bfloat16"),
    (1, 512, 8, 1, 256, 0, "bfloat16"),
    (2, 512, 4, 4, 64, 0, "bfloat16"),
    (1, 512, 8, 4, 128, 100, "bfloat16"),
    (2, 300, 4, 4, 128, 64, "bfloat16"),
    (1, 512, 4, 2, 256, 64, "bfloat16"),
    (8, 512, 24, 24, 64, 0, "bfloat16"),
    (4, 512, 24, 24, 64, 0, "bfloat16"),
    (4, 768, 8, 1, 256, 0, "bfloat16"),
    (4, 512, 8, 1, 256, 0, "bfloat16"),
    (4, 512, 64, 8, 128, 0, "bfloat16"),
    (1, 128, 4, 2, 64, 0, "float16"),
    (2, 17, 16, 2, 128, 0, "float16"),
    (1, 300, 4, 2, 256, 64, "float16"),
    (4, 512, 16, 8, 128, 0, "float16"),
    (1, 300, 4, 2, 320, 64, "float16"),
    (1, 200, 4, 1, 300, 0, "float32"),
    (2, 130, 8, 1, 576, 0, "bfloat16"),
]
# (b, s, h, kv, d, window, dtype), causal=False: the bf16 instance without
# the causal bound, ragged, and with a window that starts mid-tile; the f16
# twin, and the wide instance with a window
FLASH_NON_CAUSAL = [
    (1, 300, 4, 2, 128, 0, "bfloat16"),
    (2, 17, 8, 1, 64, 0, "bfloat16"),
    (1, 300, 4, 1, 64, 100, "bfloat16"),
    (1, 300, 4, 2, 128, 0, "float16"),
    (2, 100, 4, 1, 512, 64, "bfloat16"),
]


def flash_inputs(b, s, h, kv, d, dtype, seed, device):
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    return [torch.tensor(rng.standard_normal(shape), dtype=torch.float32
                         ).to(device, dt)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]


def assert_flash_close(out, q, k, v, causal=True, window=0):
    """Kernel vs plain version, within ``ref.allowed_error`` (the rule
    ``chip_smoke.py`` holds the kernel to as well)."""
    want, allowed = fa_ref.allowed_error(q, k, v, causal=causal,
                                         window=window)
    err = (out.double() - want).abs()
    assert bool(torch.isfinite(out).all())
    assert bool((err <= allowed).all()), \
        f"off by {float(err.max())}, {int((err > allowed).sum())} beyond"


@pytest.mark.parametrize("b,s,h,kv,d,window,dtype", FLASH_CASES)
def test_flash_attention_matches_plain(b, s, h, kv, d, window, dtype,
                                       cuda_device):
    q, k, v = flash_inputs(b, s, h, kv, d, dtype, s + h + d + window,
                           cuda_device)
    before = fa_ops.launches
    out = fa_ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    assert_flash_close(out, q, k, v, window=window)


# (b, s, h, kv, d, window, causal): the f32 (CUDA-core) instance's tiles
# (128 query rows, 64 at D = 256; 64-key tiles): S = 1, 63, 65, 200 and
# 1000, windows of 1, one key tile (64) and >= S, non-causal with and
# without a window, D = 64, 128 and 256, GQA groups of 1, 2 and 8
FLASH_F32_TILES = [
    (2, 1, 4, 2, 128, 0, True), (2, 63, 4, 2, 128, 0, True),
    (2, 65, 4, 2, 128, 0, True), (1, 200, 4, 2, 128, 0, True),
    (1, 1000, 4, 2, 128, 0, True), (1, 300, 4, 2, 128, 1, True),
    (1, 300, 4, 2, 128, 64, True), (1, 300, 4, 2, 256, 64, True),
    (1, 300, 4, 2, 128, 300, True), (1, 300, 4, 2, 128, 1000, True),
    (1, 300, 4, 2, 128, 0, False), (2, 200, 4, 1, 64, 100, False),
    (2, 300, 4, 4, 64, 0, True), (2, 300, 8, 4, 128, 0, True),
    (1, 300, 8, 1, 256, 0, True), (1, 300, 8, 1, 128, 0, True),
    (1, 300, 2, 2, 256, 0, False),
]


@pytest.mark.parametrize("b,s,h,kv,d,window,causal", FLASH_F32_TILES)
def test_flash_attention_f32_tiles_match_plain(b, s, h, kv, d, window,
                                               causal, cuda_device):
    q, k, v = flash_inputs(b, s, h, kv, d, "float32",
                           s + h + d + window + causal, cuda_device)
    before = fa_ops.launches
    out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    assert out.shape == q.shape and out.dtype == q.dtype
    assert_flash_close(out, q, k, v, causal=causal, window=window)


def test_flash_attention_long_context_window_matches_plain(cuda_device):
    """qwen3-1.7b's long-context prefill, (2, 12288, 16, 8, 128) at the
    reference's window of 8192 (the kernel's window branch skips each
    query tile's dead key tiles): one launch, held to the plain version
    one (batch row, KV head) at a time (each query head sees its own KV
    head only; the whole plain version's logits would take 19 GB)."""
    b, s, h, kv, d, window = 2, 12288, 16, 8, 128, 8192
    q, k, v = flash_inputs(b, s, h, kv, d, "bfloat16", 5, cuda_device)
    before = fa_ops.launches
    out = fa_ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    g = h // kv
    for i in range(b):
        for j in range(kv):
            heads = slice(j * g, (j + 1) * g)
            assert_flash_close(out[i:i + 1, :, heads], q[i:i + 1, :, heads],
                               k[i:i + 1, :, j:j + 1], v[i:i + 1, :, j:j + 1],
                               window=window)


@pytest.mark.parametrize("b,s,h,kv,d,window,dtype", FLASH_NON_CAUSAL)
def test_flash_attention_non_causal_matches_plain(b, s, h, kv, d, window,
                                                  dtype, cuda_device):
    q, k, v = flash_inputs(b, s, h, kv, d, dtype, s + h + d + window + 1,
                           cuda_device)
    before = fa_ops.launches
    out = fa_ops.flash_attention(q, k, v, causal=False, window=window)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    assert_flash_close(out, q, k, v, causal=False, window=window)


def test_flash_attention_non_causal_and_empty(cuda_device):
    q, k, v = flash_inputs(1, 200, 4, 2, 64, "float32", 5, cuda_device)
    out = fa_ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert_flash_close(out, q, k, v, causal=False)
    before = fa_ops.launches
    empty = fa_ops.flash_attention(q[:0], k[:0], v[:0])
    assert fa_ops.launches == before and empty.shape == (0, 200, 4, 64)


def test_flash_attention_grad_goes_through_the_plain_backward(cuda_device):
    q, k, v = (t.requires_grad_() for t in flash_inputs(
        2, 128, 4, 2, 64, "float32", 9, cuda_device))
    got = torch.autograd.grad(fa_ops.flash_attention(q, k, v).square().sum(),
                              (q, k, v))
    want = torch.autograd.grad(fa_ref.attention_ref(q, k, v).square().sum(),
                               (q, k, v))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_ssd_grad_through_the_kernel_forward_equals_the_plain_forward(
        cuda_device):
    """mamba2-370m's SSD at f32 (32 heads of 64, d_state 128, chunk 128):
    the op's forward launches the kernel once, its backward re-runs the
    plain version, and the gradients of a loss of both outputs equal
    those through the plain forward."""
    x, da, bm, cm = (t.requires_grad_() for t in ssd_inputs(
        2, 512, 32, 64, 128, "float32", 21, cuda_device))
    before = ssd_ops.launches
    y, state = ssd_ops.ssd(x, da, bm, cm, 128)
    got = torch.autograd.grad(y.square().sum() + state.square().sum(),
                              (x, da, bm, cm))
    assert ssd_ops.launches == before + 1
    y, state = ssd_ref.ssd_reference(x, da, bm, cm, 128)
    want = torch.autograd.grad(y.square().sum() + state.square().sum(),
                               (x, da, bm, cm))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()))


def _moe_block(arch, shape, device):
    """A full-width MoE FFN of ``arch`` (weights from a seeded CPU
    generator) and a seeded f32 input of ``shape`` [B, S]."""
    from repro_torch.models import moe
    cfg = get_config(arch).model
    gen = torch.Generator().manual_seed(0)
    p = {k: v.to(device) for k, v in moe.init_moe(gen, cfg).items()}
    x = torch.randn(*shape, cfg.d_model, generator=gen).to(device)
    return cfg, p, x


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-moe-16b"])
def test_moe_ffn_on_the_card_equals_the_cpu(arch, cuda_device):
    """The same weights and f32 input (256 tokens: dropless) on the card
    and on the CPU: the same expert choices, y within 1e-5 and every aux
    value within 1e-6 (absolute plus relative)."""
    from repro_torch.models import moe
    cfg, p, x = _moe_block(arch, (2, 128), cuda_device)
    with torch.no_grad():
        y, aux = moe.moe_ffn(p, cfg, x)
        idx = moe.route(p["router"], x.reshape(-1, cfg.d_model),
                        cfg.moe.top_k)[3]
        pc = {k: v.cpu() for k, v in p.items()}
        y_c, aux_c = moe.moe_ffn(pc, cfg, x.cpu())
        idx_c = moe.route(pc["router"], x.cpu().reshape(-1, cfg.d_model),
                          cfg.moe.top_k)[3]
    assert torch.equal(idx.cpu(), idx_c)
    torch.testing.assert_close(y.cpu(), y_c, rtol=1e-5, atol=1e-5)
    for k in aux_c:
        torch.testing.assert_close(aux[k].cpu(), aux_c[k], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_moe_combine_is_deterministic_on_the_card(dtype, cuda_device):
    """olmoe's MoE FFN over a serving prefill's 2048 tokens (capacity
    drops included) three times: bit-equal outputs, as greedy tokens need
    (the combine sums each token's k rows in a fixed order, where
    ``index_add_``'s atomics would not)."""
    from repro_torch.models import moe
    cfg, p, x = _moe_block("olmoe-1b-7b", (4, 512), cuda_device)
    x = x.to(getattr(torch, dtype))
    with torch.no_grad():
        ys = [moe.moe_ffn(p, cfg, x)[0] for _ in range(3)]
    assert all(torch.equal(ys[0], y) for y in ys[1:])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "minicpm-2b"])
def test_attention_fill_kernel_equals_naive_fill_at_ragged_s(arch, dtype,
                                                             cuda_device):
    """One full-width attention layer's prefill (qwen3: 16 query and 8 KV
    heads of 128; minicpm: 36 heads of 64) at S = 515, not a multiple of
    the kernel's 64-row tiles, as a mid-flight admission prefill is: the
    kernel fill launches once, writes the naive fill's K/V bit for bit,
    its attention lies within ``ref.allowed_error`` of the plain version
    and (f32) its output within 1e-3 of the naive fill's."""
    import dataclasses

    from repro_torch.models import layers as L
    cfg = dataclasses.replace(get_config(arch).model, dtype=dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    p = L.init_attention(gen, cfg)
    dt = getattr(torch, dtype)
    x = torch.randn(2, 515, cfg.d_model, generator=gen,
                    device=cuda_device).to(dt)
    pos = torch.arange(515, device=cuda_device)
    cache = torch.zeros(2, 600, cfg.n_kv_heads, cfg.resolved_head_dim,
                        dtype=dt, device=cuda_device)
    before = fa_ops.launches
    yk, kk, vk = L.attention_fill(p, cfg, x, pos, cache.clone(),
                                  cache.clone(), impl="kernel")
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    yn, kn, vn = L.attention_fill(p, cfg, x, pos, cache.clone(),
                                  cache.clone(), impl="naive")
    assert fa_ops.launches == before + 1
    assert torch.equal(kk, kn) and torch.equal(vk, vn)
    assert not kk[:, 515:].any()
    q, k, v = L._qkv(p, cfg, x, pos)
    assert_flash_close(fa_ops.flash_attention(q, k, v), q, k, v)
    assert bool(torch.isfinite(yk).all())
    if dt == torch.float32:
        rel = float((yk - yn).abs().max()) / float(yn.abs().max())
        assert rel <= 1e-3, rel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jamba_smoke_kernel_fill_equals_the_naive_fill(dtype, cuda_device):
    """jamba-1.5's smoke config over two groups of its full 8-layer
    pattern (16 layers: Mamba and attention layers, dense and MoE FFNs):
    a prefill through both kernels (one flash_attention launch per
    attention layer, one ssd_scan per Mamba layer) and through naive
    attention and the plain SSD, the plain run on the kernel run's
    replayed expert choices; then 8 greedy decode steps from each cache.
    At f32 logits, every K/V and SSM state within 1e-3 of their largest
    magnitude and the greedy tokens equal; at bf16 finite, the first
    tokens equal wherever the kernel's top-2 margin exceeds twice the
    logits' difference."""
    import dataclasses

    from repro_torch.config import get_smoke_config
    from repro_torch.interop import tree_leaves
    from repro_torch.models import LM, moe
    full = get_config("jamba-1.5-large-398b").model
    cfg = dataclasses.replace(
        get_smoke_config("jamba-1.5-large-398b").model, n_layers=16,
        layer_pattern=full.layer_pattern, ffn_pattern=full.ffn_pattern,
        dtype=dtype)
    params = LM(cfg, device=cuda_device).init(
        torch.Generator(device=cuda_device).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (4, 200), device=cuda_device,
                         generator=torch.Generator(
                             device=cuda_device).manual_seed(1),
                         dtype=torch.int32)
    choices, route = [], moe.route

    def run(impl, replay):
        def logged(router, xf, k):
            logits, probs, gate, idx = route(router, xf, k)
            if replay is not None:
                idx = replay[len(choices)]
                gate = probs.gather(-1, idx)
                gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
            choices.append(idx)
            return logits, probs, gate, idx
        m = LM(cfg, attn_impl=impl, use_ssd_kernel=impl == "kernel",
               device=cuda_device)
        moe.route = logged
        try:
            with torch.no_grad():
                logits, cache = m.prefill(params, toks, m.init_cache(4, 216))
                first = logits[:, -1].float()
                out = [first.argmax(-1)]
                for _ in range(8):
                    logits, cache = m.decode_step(params, out[-1][:, None],
                                                  cache)
                    out.append(logits[:, -1].argmax(-1))
        finally:
            moe.route = route
        return first, cache, torch.stack(out, 1)

    before = (fa_ops.launches, ssd_ops.launches)
    kernel = run("kernel", None)
    kinds = cfg.layer_kinds()
    assert (fa_ops.launches - before[0], ssd_ops.launches - before[1]) == (
        kinds.count("attn"), kinds.count("mamba"))
    replay, choices[:] = list(choices), []
    naive = run("naive", replay)
    assert (fa_ops.launches, ssd_ops.launches) == (
        before[0] + kinds.count("attn"), before[1] + kinds.count("mamba"))
    (lk, ck, tk), (ln, cn, tn) = kernel, naive
    assert bool(torch.isfinite(lk).all())
    if dtype == "float32":
        for a, b in zip(tree_leaves(ck), tree_leaves(cn)):
            a, b = a.float(), b.float()
            assert float((a - b).abs().max()) <= 1e-3 * max(
                float(b.abs().max()), 1e-30)
        assert float((lk - ln).abs().max()) <= 1e-3 * float(ln.abs().max())
        assert torch.equal(tk, tn)
    else:
        top2 = lk.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        sure = margin > 2 * float((lk - ln).abs().max())
        assert torch.equal(tk[sure, 0], tn[sure, 0])


def test_flash_attention_rejects_what_the_kernel_cannot_take(cuda_device,
                                                             monkeypatch):
    """Non-contiguous inputs raise; the op never gives way to the plain
    version.  (D = 32 runs on the D = 64 instance:
    ``test_flash_attention_padded_head_dims_match_plain``; D = 512, the
    old refusal's shape, runs on the wide instance, here in every dtype
    against the plain version, which is patched to fail inside the op,
    each launch counted.)"""
    plain = fa_ops.attention_ref
    monkeypatch.setattr(fa_ops, "attention_ref", lambda *a, **k: pytest.fail(
        "the plain forward ran for a CUDA tensor"))
    before = fa_ops.launches
    q, k, v = flash_inputs(1, 64, 2, 2, 64, "float32", 1, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                               k, v)
    assert fa_ops.launches == before
    outs = {}
    assert fa_kernel.library().flash_attention_wide_smem() \
        == fa_kernel.smem_bytes(512, torch.bfloat16)
    for dtype in ("float32", "bfloat16", "float16"):
        assert fa_kernel.smem_bytes(512, getattr(torch, dtype)) \
            <= fa_kernel.max_smem(0)
        inputs = flash_inputs(1, 64, 2, 2, 512, dtype, 1, cuda_device)
        outs[dtype] = (inputs, fa_ops.flash_attention(*inputs))
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 3
    monkeypatch.setattr(fa_ops, "attention_ref", plain)
    for (q, k, v), out in outs.values():
        assert out.dtype == q.dtype and out.shape == q.shape
        assert_flash_close(out, q, k, v)


# (b, s, h, kv, d, window, dtype): head dims no instance has, zero-padded
# to the next one: D = 32 and 48 (the 5m preset's) on the D = 64 instance,
# 96 (Phi-3-mini's) on 128, 160 on 256; a window and a GQA group; the 5m
# preset's training shape, and bf16 at (8, 512, 32, 32, 96)
FLASH_PADDED = [(1, 64, 2, 2, 32, 0, "float32"),
                (4, 256, 4, 4, 48, 0, "float32"),
                (2, 300, 4, 2, 48, 100, "bfloat16"),
                (1, 300, 8, 2, 96, 0, "float32"),
                (2, 512, 32, 32, 96, 0, "bfloat16"),
                (1, 200, 4, 4, 160, 64, "float32"),
                (1, 256, 8, 1, 160, 0, "bfloat16")]


@pytest.mark.parametrize("b,s,h,kv,d,window,dtype", FLASH_PADDED)
def test_flash_attention_padded_head_dims_match_plain(b, s, h, kv, d, window,
                                                      dtype, cuda_device,
                                                      monkeypatch):
    q, k, v = flash_inputs(b, s, h, kv, d, dtype, s + h + d + window,
                           cuda_device)
    plain = fa_ops.attention_ref
    monkeypatch.setattr(fa_ops, "attention_ref", lambda *a, **kw: pytest.fail(
        "the plain forward ran for a CUDA tensor"))
    before = fa_ops.launches
    out = fa_ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    monkeypatch.setattr(fa_ops, "attention_ref", plain)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert out.is_contiguous()
    assert_flash_close(out, q, k, v, window=window)


# -- the device telemetry rings and program profiles on the card ------------------


def _el_session(arch, mode, dev, init=None, batch_k=1, n_events=160):
    """A kmeans-traffic / svm-wafer session on ``dev`` and numpy-replayed
    draws for it; ``init`` (numpy) shares one initialization between
    devices."""
    import dataclasses
    from repro_torch.el import ELSession
    from repro_torch.el.rng import ReplayDraws
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.launch.classic import classic_fixture
    fx = classic_fixture(arch, samples=2000, n_edges=4, device=dev)
    cfg = dataclasses.replace(fx["exp"].ol4el, mode=mode, n_edges=4,
                              budget=3000.0 if mode == "sync" else 1500.0,
                              utility=fx["utility"], heterogeneity=2.0,
                              async_batch_k=batch_k)
    init = params_to_numpy(fx["init_params"]) if init is None else init
    rng = np.random.default_rng(0)
    k, batch = cfg.max_interval, fx["executor"].batch
    if mode == "sync":
        draws = ReplayDraws(rng.gumbel(size=(128, k)),
                            rng.uniform(size=(128, 4, k, batch)),
                            rng.standard_normal((128, 4)))
    else:
        draws = ReplayDraws(rng.gumbel(size=(n_events, 4, k)),
                            rng.uniform(size=(n_events, 4, k, batch)),
                            rng.standard_normal((n_events, 4)),
                            init_gumbel=rng.gumbel(size=(4, k)),
                            init_normal=rng.standard_normal(4))
    sess = (ELSession(cfg, metric_name=fx["metric"], lr=fx["lr"])
            .with_executor(fx["executor"],
                           init_params=params_from_numpy(init, dev),
                           n_samples=fx["n_samples"]
                           if mode == "sync" else None))
    return sess, draws, init


@pytest.mark.parametrize("mode,batch_k", [("sync", 1), ("async", 1),
                                          ("async", 4)])
def test_rings_under_a_captured_graph_equal_the_oracle(mode, batch_k,
                                                       cuda_device):
    """Rings recorded inside CUDA-graph replays (ring 16, so they wrap):
    equal to the numpy replay oracle of the card's own history bit for
    bit, their decisions those of the CPU's ringed run, and the run the
    unringed one."""
    from repro_torch.el import events, ingraph
    from repro_torch.obs import rings
    reps = {}
    init = None
    for dev in ("cuda", "cpu"):
        sess, draws, init = _el_session("kmeans-traffic", mode, dev, init,
                                        batch_k)
        run = (sess.run_sync_ingraph if mode == "sync"
               else sess.run_async_ingraph)
        reps[dev] = run(draws=draws, telemetry=16)
        if dev == "cuda":
            loop = reps[dev].telemetry["device_loop"]
            assert loop["graphs_captured"] == 1 and loop["replays"] > 0
            off = run(draws=draws)
            assert [r.interval for r in off.records] == \
                [r.interval for r in reps[dev].records]
            assert "rings" not in off.telemetry
            cfg = sess.cfg
            out = reps[dev].raw
            if mode == "sync":
                want = rings.sync_reference_telemetry(
                    out, ingraph.sync_knobs(cfg), cfg.max_interval)
            else:
                want = rings.async_reference_telemetry(
                    out, events.async_knobs(cfg), 4, cfg.max_interval)
            got = rings.unroll_ring(reps[dev].telemetry["rings"])
            assert int(reps[dev].telemetry["rings"]["head"]) == \
                reps[dev].n_aggregations > 16
            for k, v in want.items():
                np.testing.assert_array_equal(got[k], v, err_msg=k)
    gpu = rings.unroll_ring(reps["cuda"].telemetry["rings"])
    cpu = rings.unroll_ring(reps["cpu"].telemetry["rings"])
    for k in ("arm", "arm_counts") + (("edge",) if mode == "async" else ()):
        np.testing.assert_array_equal(gpu[k], cpu[k], err_msg=k)


def test_profiles_on_the_card_have_their_memory_fields(cuda_device):
    """``profile=True, contract=True`` on the card: the allocator's
    chunk peak, the reference's peak sum, no collectives, nothing
    aliased; the profile captured the graph the run then replays, and the
    run is the unprofiled run.  An impossible contract raises before
    any replay."""
    from repro_torch.obs import prof
    sess, draws, init = _el_session("kmeans-traffic", "sync", "cuda")
    rep = sess.run_sync_ingraph(draws=draws, profile=True, contract=True)
    p = rep.telemetry["profile"]
    assert p["backend"] == "cuda" and p["errors"] == []
    assert p["collectives"] == {} and p["alias_bytes"] == 0
    assert p["temp_bytes"] > 0
    assert p["peak_live_bytes"] == (p["argument_bytes"] + p["output_bytes"]
                                    + p["temp_bytes"] - p["alias_bytes"])
    assert rep.telemetry["device_loop"]["graphs_captured"] == 0
    plain, draws2, _ = _el_session("kmeans-traffic", "sync", "cuda", init)
    ref = plain.run_sync_ingraph(draws=draws2)
    assert [r.interval for r in rep.records] == \
        [r.interval for r in ref.records]
    fresh, draws3, _ = _el_session("kmeans-traffic", "sync", "cuda", init)
    with pytest.raises(prof.ContractViolation, match="impossible"):
        fresh.run_sync_ingraph(draws=draws3, contract=prof.CollectiveContract(
            "impossible", counts={"all-gather": (5, 99)}))
    assert fresh._fastpath.replays == 0


def test_microbench_kernel_row_equals_the_plain_version(cuda_device):
    """The microbenchmark's E-step kernel row at (4096, 64, 3): every
    assignment the plain version's, every distance within
    ``ref.allowed_error``, its launches counted."""
    from repro_torch.bench import microbench
    x, c = microbench.kmeans_inputs(cuda_device)
    before = ops.launches
    row = microbench.kmeans_kernel_row(x, c)
    assert row["name"] == "kmeans_assign_n4096_d64_k3"
    assert row["assign_mismatches"] == 0 and row["beyond_allowed"] == 0
    assert row["launches"] == ops.launches - before == 1 + 3 + 20
    assert 0 < row["us_per_call"] < 1e4
    assert f"launches={row['launches']}" in row["derived"]


def test_bench_el_smoke_on_the_card(cuda_device):
    """``bench_el`` at the smoke gate's sizes on the card: the port's
    compiled tiers, the donated and sharded ones included (the sharded
    from 4 gloo ranks on this card), each profiled with the allocator's
    chunk peak, the contracts holding (gathers only where sharded, the
    params aliased only where donated), the card named in ``meta``."""
    from repro_torch.bench import bench_check, bench_el
    args = bench_el.parser().parse_args(
        ["--device", "cuda", "--edges", "4", "--samples", "512",
         "--batch", "64", "--budget", "300", "--max-rounds", "16",
         "--max-events", "64", "--repeats", "2", "--skip-host",
         "--no-history"])
    report = bench_el.bench(args)
    rows = report["rows"]
    assert sorted(rows) == sorted(
        ["el_sync_ingraph", "el_sync_ingraph_telemetry",
         "el_sync_ingraph_churn", "el_async_ingraph",
         "el_async_ingraph_telemetry", "el_async_ingraph_batched"]
        + [f"el_{mode}_{tier}" for mode in ("sync", "async")
           for tier in ("ingraph_donate", "sharded", "sharded_donate")])
    assert report["meta"]["ranks"]["cards"] == 1
    for name, row in rows.items():
        assert row["n_aggregations"] > 0, name
        assert "profile_errors" not in row, (name, row["profile_errors"])
        assert row["temp_bytes"] is not None and row["peak_live_bytes"] > 0
    assert [f.kind for f in bench_check.contract_findings(rows)] == ["ok"]
    assert report["meta"]["backend"] == "cuda"
    assert report["meta"]["device_name"]
    assert report["meta"]["power_limit"].endswith("W")


# -- the planner: the kernels' meta paths and a measured plan ----------------

def _old_phase8_work(kind, *shape):
    """Each kernel's (operations, bytes) as phase 8 of ``chip_smoke.py``
    wrote them before they moved into ``ops.work``."""
    if kind == "kmeans_assign":
        e, n, d, k = shape
        return (e * (2 * n * k * d + 2 * n * d + 2 * k * d + 3 * n * k),
                e * ((n * d + k * d) * 4 + n * (4 + 4)))
    if kind == "ssd_scan":
        b, s, h, p, n, chunk, e = shape
        tri = chunk * (chunk + 1) // 2
        n_chunks = s // chunk
        flops = b * n_chunks * 2 * tri * n \
            + b * h * n_chunks * (2 * tri * p + 4 * chunk * p * n)
        return flops, (2 * b * s * h * p * e + b * s * h * 4
                       + 2 * b * s * n * e + b * h * p * n * 4)
    b, s, h, kv, d, window, e = shape
    pairs = (s * (s + 1) // 2 if window <= 0 or window >= s
             else window * (window + 1) // 2 + (s - window) * window)
    return 4 * b * h * d * pairs, (2 * b * s * h * d + 2 * b * s * kv * d) * e


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_meta_paths_give_the_cuda_outputs_shapes_and_phase8_work(
        dtype, cuda_device):
    """On ``meta`` each wrapper returns what its kernel returns on the card
    (shapes, dtypes), launches nothing and counts the work phase 8 of
    ``chip_smoke.py`` reported at the main paths' shapes."""
    dt = getattr(torch, dtype)
    cases = [
        (fa_ops, "flash_attention", (4, 512, 16, 8, 128, 0)),
        (fa_ops, "flash_attention", (2, 12288, 16, 8, 128, 8192)),
        (ssd_ops, "ssd_scan", (4, 512, 32, 64, 128, 128)),
        (ops, "kmeans_assign", (4, 128, 64, 3)),
    ]
    for mod, kind, shape in cases:
        gen = torch.Generator().manual_seed(0)
        if kind == "flash_attention":
            b, s, h, kv, d, w = shape
            if s > 4096 and dtype == "float32":
                continue
            args = [torch.randn(b, s, n, d, generator=gen).to(dt)
                    for n in (h, kv, kv)]

            def call(*t, w=w):
                return fa_ops.flash_attention(*t, window=w)
            want_work = _old_phase8_work(kind, *shape, dt.itemsize)
        elif kind == "ssd_scan":
            b, s, h, p, n, chunk = shape
            args = [torch.randn(b, s, h, p, generator=gen).to(dt) * 0.1,
                    -torch.rand(b, s, h, generator=gen) * 0.1,
                    torch.randn(b, s, n, generator=gen).to(dt) * 0.1,
                    torch.randn(b, s, n, generator=gen).to(dt) * 0.1]

            def call(*t, chunk=chunk):
                return ssd_ops.ssd(*t, chunk)
            want_work = _old_phase8_work(kind, *shape, dt.itemsize)
        else:
            if dtype != "float32":
                continue
            e, n, d, k = shape
            args = [torch.randn(e, n, d, generator=gen),
                    torch.randn(e, k, d, generator=gen)]
            call = ops.assign_with_dist_batched
            want_work = _old_phase8_work(kind, *shape)
        card = call(*(t.to(cuda_device) for t in args))
        card = card if isinstance(card, tuple) else (card,)
        mod.meta_flops = mod.meta_bytes = 0
        launches = (mod.launches, getattr(mod, "batched_launches", 0))
        meta = call(*(torch.empty_like(t, device="meta") for t in args))
        meta = meta if isinstance(meta, tuple) else (meta,)
        assert [(t.shape, t.dtype) for t in meta] \
            == [(t.shape, t.dtype) for t in card], kind
        assert (mod.launches, getattr(mod, "batched_launches", 0)) \
            == launches
        assert (mod.meta_flops, mod.meta_bytes) == want_work, kind


@pytest.mark.parametrize("kind,batch,seq", [("prefill", 2, 64),
                                            ("train", 2, 64),
                                            ("decode", 2, 64)])
def test_dryrun_measure_agrees_with_its_plan(kind, batch, seq, cuda_device):
    """``dryrun``'s plan of qwen3-1.7b smoke against the peak the card
    measures around the same step, within the 15 % that phase 9 of
    ``chip_smoke.py`` holds the full-width rows to."""
    from repro_torch.config import get_smoke_config
    from repro_torch.launch import dryrun
    cfg = get_smoke_config("qwen3-1.7b").model
    plan = dryrun.plan_model(cfg, kind, batch, seq)
    got = dryrun.measure_model(cfg, kind, batch, seq, cuda_device)
    err = plan["memory"]["peak_live_bytes"] / got["peak_bytes"] - 1.0
    assert abs(err) <= 0.15, (plan["memory"], got)
    if kind != "decode":
        assert got["launches"]["flash_attention"] > 0


# -- several ranks on the card (the sharded sync run) -----------------------------

_RANK_CODE = """
import pickle, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_debug_mesh
sys.path.insert(0, {tests!r})
from test_torch_kernels_cuda import _sharded_async_run, _sharded_sync_run
resolve_device("cuda")
mesh = make_debug_mesh({n}, 1, device="cuda", backend={backend!r})
out = _sharded_sync_run(mesh, {arch!r})
if {with_async!r}:
    out["async"] = _sharded_async_run(mesh)
with open({out!r} + f"/rank{{mesh.rank}}.pkl", "wb") as f:
    pickle.dump(out, f)
dist.destroy_process_group()
"""


def _sharded_sync_run(mesh=None, arch="kmeans-traffic"):
    """``arch`` (2,000 samples, 4 edges) through the compiled sync round
    on the card, on draws replayed from a seeded numpy generator, over
    ``mesh`` (None: unsharded); records, final params, census."""
    import dataclasses
    from repro_torch.el import ELSession
    from repro_torch.el.rng import ReplayDraws
    from repro_torch.interop import tree_to_numpy
    from repro_torch.launch.classic import classic_fixture
    fx = classic_fixture(arch, samples=2000, n_edges=4, device="cuda")
    cfg = dataclasses.replace(fx["exp"].ol4el, mode="sync", n_edges=4,
                              budget=3000.0, utility=fx["utility"])
    rng = np.random.default_rng(4)
    k, b = cfg.max_interval, fx["executor"].batch
    draws = ReplayDraws(rng.gumbel(size=(128, k)),
                        rng.uniform(size=(128, 4, k, b)),
                        rng.standard_normal((128, 4)))
    sess = (ELSession(cfg, metric_name=fx["metric"], lr=fx["lr"])
            .with_executor(fx["executor"], init_params=fx["init_params"],
                           n_samples=fx["n_samples"]))
    rep = sess.run_sync_ingraph(max_rounds=128, draws=draws, mesh=mesh,
                                contract=True)
    return {"records": [(r.interval, r.total_consumed, r.wall_time,
                         r.utility) for r in rep.records],
            "params": tree_to_numpy(rep.final_params),
            "collectives": rep.telemetry["profile"]["collectives"],
            "graphs": rep.telemetry["device_loop"]["graphs_captured"],
            # the profile (contract=True) captures before the run replays
            "graphs_total": sess._fastpath.graphs_captured,
            "replays": rep.telemetry["device_loop"]["replays"]}


def _world_equals_unsharded(n, backend, tmp_path, with_async=False,
                            arch="kmeans-traffic"):
    import os
    import pathlib
    import pickle
    import sys
    from repro_torch.launch.hostdev import spawn_ranks
    tests = str(pathlib.Path(__file__).resolve().parent)
    code = _RANK_CODE.format(tests=tests, n=n, backend=backend,
                             out=str(tmp_path), with_async=with_async,
                             arch=arch)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(pathlib.Path(tests).parent / "src"), tests]))
    procs = spawn_ranks(n, [sys.executable, "-c", code], env=env,
                        capture=True, timeout=600)
    for p in procs:
        assert p.returncode == 0, p.stderr[-3000:]
    want = _sharded_sync_run(arch=arch)
    # the unsharded run replays the graph its profile captured
    assert want["collectives"] == {} and want["replays"] > 0
    want_async = _sharded_async_run() if with_async else None
    for r in range(n):
        got = pickle.load(open(tmp_path / f"rank{r}.pkl", "rb"))
        assert got["records"] == want["records"]
        for key, v in want["params"].items():
            np.testing.assert_array_equal(got["params"][key], v)
        assert got["collectives"]["all-gather"]["count"] >= 1
        assert "all-reduce" not in got["collectives"]
        _assert_chunks(got, backend)
        if with_async:
            a = got["async"]
            assert a["batch_k"] == want_async["batch_k"] == 4
            assert a["events"] == want_async["events"]
            for key, v in want_async["params"].items():
                np.testing.assert_array_equal(a["params"][key], v)
            assert a["collectives"]["all-gather"]["count"] >= 1
            assert "all-reduce" not in a["collectives"]
            _assert_chunks(a, backend)


def _assert_chunks(got, backend):
    """A gloo rank's chunks run eagerly: no graph, no replay.  An NCCL
    rank's are CUDA graphs that hold their gathers, captured (by the
    profile) and replayed as an unsharded run's."""
    if backend == "gloo":
        assert got["graphs_total"] == 0
        assert got["graphs"] == 0 and got["replays"] == 0
    else:
        assert got["graphs_total"] >= 1 and got["replays"] > 0


def test_gloo_ranks_on_one_card_shard_the_sync_run(cuda_device, tmp_path):
    """Two gloo ranks share the card (CUDA tensors): every rank's sharded
    run is the unsharded card run, bit for bit, with one all-gather a
    round and no all-reduce."""
    _world_equals_unsharded(2, "gloo", tmp_path)


def test_gloo_ranks_of_one_edge_on_one_card_shard_the_sync_run(
        cuda_device, tmp_path):
    """Four gloo ranks share the card, one svm-wafer edge each (a (4, 1)
    mesh): each rank runs its lane beside a copy, since cuBLAS rounds a
    batched GEMM of one matrix apart from one of several, and every
    rank's run is the unsharded card run bit for bit."""
    _world_equals_unsharded(4, "gloo", tmp_path, arch="svm-wafer")


def test_nccl_ranks_shard_the_sync_run(cuda_device, tmp_path):
    """One NCCL rank a card over every card of the machine (NCCL puts no
    two ranks of one communicator on one card): the sharded sync run and
    the async run at K = 4, their chunks CUDA graphs that hold their
    gathers, each the unsharded card run bit for bit; skips on a machine
    with one card."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("an NCCL world of several ranks needs several cards")
    _world_equals_unsharded(2 if n < 4 else 4, "nccl", tmp_path,
                            with_async=True)


_GATHER_RANK_CODE = """
import pickle, sys
import torch
import torch.distributed as dist
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh
sys.path.insert(0, {tests!r})
from test_torch_kernels_cuda import _captured_gather
resolve_device("cuda")
mesh = make_mesh((1, 1), ("data", "model"))
out = _captured_gather(mesh)
with open({out!r} + "/gather.pkl", "wb") as f:
    pickle.dump(out, f)
dist.destroy_process_group()
"""


def _captured_gather(mesh):
    """``gather_edge_stack`` over ``mesh``'s edge group and the f32 mean
    of the stack in edge order, a rank's 2 edges of svm-wafer-like
    leaves: its census on an eager warm-up (a side stream), then one CUDA
    graph of it replayed on fresh inputs, each replay against the same
    ops run eagerly."""
    from repro_torch.launch.mesh import gather_edge_stack
    from repro_torch.obs.prof import collective_census
    group = mesh.edge_group()
    gen = torch.Generator(device="cuda").manual_seed(3)
    shapes = {"w": (2, 59, 8), "b": (2, 8)}

    def fresh():
        return {k: torch.randn(v, generator=gen, device="cuda")
                for k, v in shapes.items()}

    def body(tree):
        out = {}
        for k, v in gather_edge_stack(tree, group).items():
            acc = v[0].clone()
            for e in range(1, v.shape[0]):
                acc = acc + v[e]
            out[k] = acc / v.shape[0]
        return out
    static = fresh()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        census = collective_census(lambda: body(static),
                                   torch.device("cuda"))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        result = body(static)
    same = []
    for _ in range(4):
        tree = fresh()
        for k, v in tree.items():
            static[k].copy_(v)
        graph.replay()
        want = body(tree)
        same.append(all(torch.equal(result[k], want[k]) for k in want))
    return {"census": census, "same": same}


def test_nccl_world_of_one_captures_the_edge_gather(cuda_device, tmp_path):
    """An NCCL world of one (one card): a CUDA graph holds the edge
    gather and the edge-order mean; each replay on fresh inputs is the
    same ops run eagerly, bit for bit, and the warm-up's census is the
    one all-gather with the rank's bytes (a world of one copies; the host
    op counts it)."""
    import os
    import pathlib
    import pickle
    import sys
    from repro_torch.launch.hostdev import spawn_ranks
    tests = str(pathlib.Path(__file__).resolve().parent)
    code = _GATHER_RANK_CODE.format(tests=tests, out=str(tmp_path))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(pathlib.Path(tests).parent / "src"), tests]))
    procs = spawn_ranks(1, [sys.executable, "-c", code], env=env,
                        capture=True, timeout=600)
    assert procs[0].returncode == 0, procs[0].stderr[-3000:]
    got = pickle.load(open(tmp_path / "gather.pkl", "rb"))
    assert got["same"] == [True] * 4
    census, nbytes = got["census"]
    assert census == {"all-gather": {"count": 1,
                                     "bytes": 2 * (59 * 8 + 8) * 4}}
    assert nbytes == 2 * (59 * 8 + 8) * 4


def test_planned_sharded_cell_captured_is_the_eager_cell(cuda_device):
    """kmeans-traffic's sync cell over a ``PlanMesh(2)`` (rank 0's 2 of 4
    edges; a plan's gathers are device copies, so a graph holds them):
    captured once and replayed, it is the same cell run eagerly
    (``capturable=False``) bit for bit; the replayed run's batched
    ``kmeans_assign`` launches are its replays times the launches a
    graph holds."""
    import dataclasses
    from repro_torch.el.ingraph import (SyncProgram, make_sync_program,
                                        sync_knobs)
    from repro_torch.el.rng import TorchDraws
    from repro_torch.interop import tree_to_numpy
    from repro_torch.launch.classic import classic_fixture
    from repro_torch.launch.mesh import PlanMesh
    fx = classic_fixture("kmeans-traffic", samples=2000, n_edges=4,
                         device="cuda")
    cfg = dataclasses.replace(fx["exp"].ol4el, mode="sync", n_edges=4,
                              budget=3000.0, utility=fx["utility"])
    ex = fx["executor"]
    prog = make_sync_program(
        ex.model, ex.edge_data, ex.eval_set, cfg, lr=ex.lr, batch=ex.batch,
        n_samples=fx["n_samples"], metric_name=fx["metric"],
        max_rounds=128, mesh=PlanMesh(2), device="cuda")
    assert prog.cell.sharded and prog.cell.capturable
    eager = SyncProgram(dataclasses.replace(prog.cell, capturable=False),
                        prog.rounds_per_chunk)

    def run(p):
        params, out = p(fx["init_params"], sync_knobs(cfg), TorchDraws(
            torch.Generator(device="cuda").manual_seed(cfg.seed + 17)))
        return tree_to_numpy(params), out
    first = run(prog)
    assert prog.last_run["graphs_captured"] == 1
    ops.batched_launches = 0
    got = run(prog)
    loop = prog.last_run
    assert loop["graphs_captured"] == 0 and loop["replays"] > 0
    assert ops.batched_launches == loop["replays"] \
        * loop["kernel_launches_per_graph"] > 0
    want = run(eager)
    assert eager.last_run["graphs_captured"] == 0
    assert eager.last_run["replays"] == 0
    for a in (first, got):
        for key, v in want[0].items():
            np.testing.assert_array_equal(a[0][key], v)
        assert a[1].keys() == want[1].keys()
        for key, v in want[1].items():
            np.testing.assert_array_equal(a[1][key], v)


_PART2_RANK_CODE = """
import pickle, sys
import torch.distributed as dist
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_debug_mesh
sys.path.insert(0, {tests!r})
from test_torch_kernels_cuda import _sharded_async_and_cohort
resolve_device("cuda")
mesh = make_debug_mesh(2, 1, device="cuda", backend="gloo")
out = _sharded_async_and_cohort(mesh)
with open({out!r} + f"/rank{{mesh.rank}}.pkl", "wb") as f:
    pickle.dump(out, f)
dist.destroy_process_group()
"""


def _sharded_async_run(mesh=None):
    """kmeans-traffic (2,000 samples, 4 edges) through the async engine
    on the card over ``mesh`` (None: unsharded) at the wave width the
    mesh resolves (pinned to 4 without one), on draws replayed from a
    seeded numpy generator: events, final params, census, graphs."""
    import dataclasses
    from repro_torch.el import ELSession
    from repro_torch.el.rng import ReplayDraws
    from repro_torch.interop import tree_to_numpy
    from repro_torch.launch.classic import classic_fixture
    fx = classic_fixture("kmeans-traffic", samples=2000, n_edges=4,
                         device="cuda")
    cfg = dataclasses.replace(fx["exp"].ol4el, mode="async", n_edges=4,
                              budget=3000.0, utility=fx["utility"],
                              async_batch_k=0 if mesh is not None else 4)
    rng = np.random.default_rng(5)
    k, b = cfg.max_interval, fx["executor"].batch
    draws = ReplayDraws(rng.gumbel(size=(256, 4, k)),
                        rng.uniform(size=(256, 4, k, b)),
                        rng.standard_normal((256, 4)),
                        init_gumbel=rng.gumbel(size=(4, k)),
                        init_normal=rng.standard_normal(4))
    sess = (ELSession(cfg, metric_name=fx["metric"], lr=fx["lr"])
            .with_executor(fx["executor"], init_params=fx["init_params"]))
    rep = sess.run_async_ingraph(draws=draws, mesh=mesh, contract=True)
    loop = rep.telemetry["device_loop"]
    return {"events": [(r.edge, r.interval, r.total_consumed, r.wall_time)
                       for r in rep.records],
            "params": tree_to_numpy(rep.final_params),
            "batch_k": loop["batch_k"],
            "collectives": rep.telemetry["profile"]["collectives"],
            "graphs": loop["graphs_captured"],
            "graphs_total": sess._fastpath.graphs_captured,
            "replays": loop["replays"]}


def _sharded_async_and_cohort(mesh=None):
    """``_sharded_async_run`` over ``mesh``, then a cohort of 4 slots
    serving 6 sync kmeans-traffic tenants (the last two admitted as slots
    free): each tenant's records and params."""
    import dataclasses
    from repro_torch.el.fleet import FleetServer, TenantRun
    from repro_torch.interop import tree_to_numpy
    from repro_torch.launch.classic import classic_fixture
    out = _sharded_async_run(mesh)
    fx = classic_fixture("kmeans-traffic", samples=2000, n_edges=4,
                         device="cuda")
    scfg = dataclasses.replace(fx["exp"].ol4el, mode="sync", n_edges=4,
                               budget=3000.0, utility=fx["utility"],
                               async_batch_k=0)
    server = FleetServer(n_slots=4, rounds_per_wave=16, mesh=mesh,
                         device="cuda")
    ids = [server.submit(TenantRun(
        cfg=dataclasses.replace(scfg, budget=1500.0 + 250.0 * i, seed=i),
        executor=fx["executor"], metric_name=fx["metric"],
        n_samples=fx["n_samples"], init_params=fx["init_params"],
        max_rounds=128)) for i in range(6)]
    reports = server.drain()
    out["tenants"] = {t: ([(r.interval, r.total_consumed, r.wall_time)
                           for r in reports[t].records],
                          tree_to_numpy(reports[t].final_params))
                      for t in ids}
    out["stats"] = server.stats()
    return out


def test_gloo_ranks_on_one_card_shard_the_async_run_and_a_cohort(
        cuda_device, tmp_path):
    """Two gloo ranks share the card (CUDA tensors): every rank's sharded
    async run (K resolved on the mesh: 4) is the unsharded K = 4 card run
    bit for bit, with all-gathers and no all-reduce and no graph; every
    tenant of the sharded cohort (2 slots a rank) is the unsharded
    server's, bit for bit."""
    import os
    import pathlib
    import pickle
    import sys
    from repro_torch.launch.hostdev import spawn_ranks
    tests = str(pathlib.Path(__file__).resolve().parent)
    code = _PART2_RANK_CODE.format(tests=tests, out=str(tmp_path))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(pathlib.Path(tests).parent / "src"), tests]))
    procs = spawn_ranks(2, [sys.executable, "-c", code], env=env,
                        capture=True, timeout=600)
    for p in procs:
        assert p.returncode == 0, p.stderr[-3000:]
    want = _sharded_async_and_cohort()
    assert want["collectives"] == {} and want["batch_k"] == 4
    for r in range(2):
        got = pickle.load(open(tmp_path / f"rank{r}.pkl", "rb"))
        assert got["batch_k"] == 4 and got["graphs"] == 0
        assert got["events"] == want["events"]
        for key, v in want["params"].items():
            np.testing.assert_array_equal(got["params"][key], v)
        assert got["collectives"]["all-gather"]["count"] >= 1
        assert "all-reduce" not in got["collectives"]
        assert got["tenants"].keys() == want["tenants"].keys()
        for t, (records, params) in want["tenants"].items():
            assert got["tenants"][t][0] == records, t
            for key, v in params.items():
                np.testing.assert_array_equal(got["tenants"][t][1][key], v)
        assert got["stats"] == want["stats"]

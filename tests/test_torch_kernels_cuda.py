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
# in bf16, D = 300 (32 lanes, past the 8 elements a lane keeps), N = 1001
# (not a multiple of the block's 16 points)
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
    # f32: both sides sum terms of size ||x||^2 ~ D in different orders;
    # bf16: the reference test's bound
    rtol, atol = (1e-4, 1e-3) if dtype == "float32" else (1e-2, 1e-2)
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


def test_kmeans_assign_rejects_what_the_kernel_cannot_take(cuda_device):
    x, c = _inputs(64, 64, 3, "float32", 1, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ops.assign_with_dist(x.T.contiguous().T, c)
    big = torch.zeros(1000, 64, device=cuda_device)   # 256 KB of centroids
    with pytest.raises(ValueError, match="shared memory"):
        ops.assign_with_dist(x, big)


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
        cuda_device):
    x, c = _batched_inputs(2, 64, 64, 3, "float32", 1, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ops.assign_with_dist_batched(x.transpose(1, 2).contiguous()
                                     .transpose(1, 2), c)
    big = torch.zeros(2, 1000, 64, device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        ops.assign_with_dist_batched(x, big)


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
# items), the mid-flight admission prefill (B = 1, S = 128), 5 chunks.
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


def test_ssd_scan_bf16_refuses_what_it_cannot_take(cuda_device,
                                                   monkeypatch):
    """N not a multiple of 16, or a plan over the card's shared memory:
    the op raises and never gives way to the plain version."""
    monkeypatch.setattr(ssd_ops, "ssd_reference", lambda *a, **k: pytest.fail(
        "the plain SSD ran for a CUDA tensor"))
    before = ssd_ops.launches
    with pytest.raises(ValueError, match="multiples of 16"):
        ssd_ops.ssd(*ssd_inputs(1, 128, 2, 32, 24, "bfloat16", 1,
                                cuda_device), 64)
    with pytest.raises(ValueError, match="shared memory"):
        ssd_ops.ssd(*ssd_inputs(1, 128, 2, 64, 256, "bfloat16", 1,
                                cuda_device), 128)
    assert ssd_ops.launches == before


def test_ssd_scan_rejects_what_the_kernel_cannot_take(cuda_device):
    x, da, bm, cm = ssd_inputs(1, 256, 2, 32, 16, "float32", 1, cuda_device)
    with pytest.raises(ValueError, match="chunk"):
        ssd_ops.ssd(x, da, bm, cm, 256)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_ops.ssd(x.transpose(1, 2).contiguous().transpose(1, 2), da, bm,
                    cm, 128)
    with pytest.raises(TypeError, match="da"):
        ssd_ops.ssd(x, da.to(torch.bfloat16), bm, cm, 128)
    assert ssd_kernel.smem_bytes(256, 256, 128, torch.float32) \
        > ssd_kernel.max_smem(0)
    big = ssd_inputs(1, 128, 1, 256, 256, "float32", 2, cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        ssd_ops.ssd(*big, 128)


# (b, s, h, kv, d, window, dtype): the reference's tests/test_kernels.py
# FLASH_CASES, then a ragged S, and the training shape (qwen3-1.7b: 16
# query heads and 8 KV heads of 128, B = 8, S = 512); then every branch of
# the bf16 (tensor-core) instance: D 64, 128 and 256, GQA groups 1, 2 and
# 8, S = 17 and 300 (not multiples of its 64-row tiles) and 512, windows
# of 100 and 64 that start mid-tile
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
]
# (b, s, h, kv, d, window, dtype), causal=False: the bf16 instance without
# the causal bound, ragged, and with a window that starts mid-tile
FLASH_NON_CAUSAL = [
    (1, 300, 4, 2, 128, 0, "bfloat16"),
    (2, 17, 8, 1, 64, 0, "bfloat16"),
    (1, 300, 4, 1, 64, 100, "bfloat16"),
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


def test_flash_attention_rejects_what_the_kernel_cannot_take(cuda_device,
                                                             monkeypatch):
    """Over the shared-memory budget (D = 512) or without a kernel instance
    the op raises; it never gives way to the plain version."""
    monkeypatch.setattr(fa_ops, "attention_ref", lambda *a, **k: pytest.fail(
        "the plain forward ran for a CUDA tensor"))
    before = fa_ops.launches
    for dtype in ("float32", "bfloat16"):
        assert fa_kernel.smem_bytes(512, getattr(torch, dtype)) \
            > fa_kernel.max_smem(0)
        with pytest.raises(ValueError, match="shared memory"):
            fa_ops.flash_attention(*flash_inputs(1, 64, 2, 2, 512, dtype, 1,
                                                 cuda_device))
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.flash_attention(*flash_inputs(1, 64, 2, 2, 32, "float32", 1,
                                             cuda_device))
    q, k, v = flash_inputs(1, 64, 2, 2, 64, "float32", 1, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                               k, v)
    assert fa_ops.launches == before

"""The port's K-means assignment op vs the JAX reference's.

The plain torch version (the wrapper's CPU path) is held to the
reference's jnp oracle and to its Pallas kernel in interpret mode on the
same numpy inputs.  The CUDA kernel itself runs only on a card: its tests
are in ``test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.kmeans_assign.ops import \
    assign_with_dist as jax_assign_with_dist  # noqa: E402
from repro.kernels.kmeans_assign.ref import \
    assign_ref as jax_assign_ref  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.kernels.kmeans_assign import kernel, ops, ref  # noqa: E402
from repro_torch.models import KMeans  # noqa: E402

# the reference's tests/test_kernels.py cases
KM_CASES = [
    (100, 8, 3, "float32"),
    (1000, 64, 3, "float32"),
    (513, 59, 8, "float32"),       # wafer dims, non-multiple of a block
    (256, 16, 32, "float32"),
    (300, 64, 3, "bfloat16"),
]


def _inputs(n, d, k, dtype, seed):
    """The same values for both frameworks: f32 numpy, rounded to bf16 by
    each side (both round to nearest even)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    c = rng.standard_normal((k, d)).astype(np.float32)
    return (jnp.asarray(x, getattr(jnp, dtype)),
            jnp.asarray(c, getattr(jnp, dtype)),
            torch.tensor(x).to(getattr(torch, dtype)),
            torch.tensor(c).to(getattr(torch, dtype)))


def _tolerance(dtype):
    # f32: the two sides sum ||x||^2 and x.c in different orders; bf16: the
    # reference test's own bound
    return (1e-5, 1e-4) if dtype == "float32" else (1e-2, 1e-2)


@pytest.mark.parametrize("oracle", ["jnp_ref", "pallas_interpret"])
@pytest.mark.parametrize("n,d,k,dtype", KM_CASES)
def test_plain_matches_reference(n, d, k, dtype, oracle):
    jx, jc, tx, tc = _inputs(n, d, k, dtype, seed=n + d + k)
    if oracle == "jnp_ref":
        a_ref, d2_ref = jax_assign_ref(jx, jc)
    else:
        a_ref, d2_ref = jax_assign_with_dist(jx, jc, interpret=True)
    a, d2 = ref.assign_ref(tx, tc)
    assert a.dtype == torch.int32 and d2.dtype == torch.float32
    assert a.shape == (n,) and d2.shape == (n,)
    rtol, atol = _tolerance(dtype)
    np.testing.assert_allclose(d2.numpy(), np.asarray(d2_ref),
                               rtol=rtol, atol=atol)
    if dtype == "float32":
        assert (a.numpy() == np.asarray(a_ref)).mean() >= 0.999


def test_tie_goes_to_lowest_index():
    _, _, x, c = _inputs(500, 16, 4, "float32", seed=3)
    c[2] = c[0]
    c[3] = c[1]
    a, _ = ref.assign_ref(x, c)
    assert not bool(((a == 2) | (a == 3)).any())
    a_jax, _ = jax_assign_ref(jnp.asarray(x.numpy()), jnp.asarray(c.numpy()))
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_jax))


def test_wrapper_on_cpu_takes_plain_path_without_launching():
    _, _, x, c = _inputs(300, 64, 3, "float32", seed=1)
    ops.launches = 0
    a, d2 = ops.assign_with_dist(x, c)
    a_ref, d2_ref = ref.assign_ref(x, c)
    assert ops.launches == 0
    assert torch.equal(a, a_ref) and torch.equal(d2, d2_ref)
    assert torch.equal(ops.assign(x, c), a_ref)


@pytest.mark.parametrize("bad", ["rank", "width", "dtype", "mixed_dtype",
                                 "no_centres"])
def test_wrapper_rejects_malformed_inputs(bad):
    x = torch.zeros(8, 4)
    c = torch.zeros(3, 4)
    if bad == "rank":
        x = x[None]
    elif bad == "width":
        c = torch.zeros(3, 5)
    elif bad == "dtype":
        x, c = x.double(), c.double()
    elif bad == "mixed_dtype":
        c = c.to(torch.bfloat16)
    else:
        c = torch.zeros(0, 4)
    with pytest.raises((ValueError, TypeError)):
        ops.assign_with_dist(x, c)


def test_kmeans_cuda_impl_refuses_cpu_tensors():
    model = KMeans(get_config("kmeans-traffic").model, impl="cuda",
                   device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="impl='torch'"):
        model.assign(params, torch.zeros(4, 64))


# (D, lanes per point): at most 8 elements a lane, a power of two <= 32.
# D = 24 and 40 give more lanes than bf16 rows have 16-byte vectors (4
# lanes for 3, 8 for 5): the kernel's lanes with no vector of their own
@pytest.mark.parametrize("d,group", [(1, 1), (8, 1), (9, 2), (16, 2),
                                     (24, 4), (40, 8), (59, 8), (64, 8),
                                     (65, 16), (256, 32), (300, 32),
                                     (4096, 32)])
def test_lane_group_follows_d(d, group):
    assert kernel.lane_group(d) == group


def test_plan_spreads_the_local_step_over_blocks():
    run = kernel.plan(64, 3, 232448)
    points = kernel.THREADS // run.group
    assert (run.block, run.group, points, run.tile) == (False, 8, 16, 3)
    assert kernel.THREADS % run.group == 0 and -(-128 // points) == 8
    assert kernel.plan(8, 3, 232448) == kernel.Plan(False, 1, 3)


def test_plan_refuses_centroids_beyond_shared_memory():
    """Centroids beyond one block's shared memory, and points wider than a
    lane group's registers (256 features), go to the block-tiled instance
    (tiles of 64 centres, D in slices); nothing is refused."""
    assert kernel.smem_bytes(64, 3) == 4 * (64 * 3 + 3)
    assert kernel.plan(64, 800, 232448) == kernel.Plan(False, 8, 800)
    assert kernel.smem_bytes(64, 1000) > 232448           # 894 fit
    block = kernel.Plan(True, 0, kernel.BLOCK_CENTRES)
    assert kernel.plan(64, 1000, 232448) == block
    assert kernel.plan(256, 3, 232448) == kernel.Plan(False, 32, 3)
    assert kernel.plan(257, 3, 232448) == block
    assert kernel.plan(4097, 3, 232448) == block


# -- the batched entry: x [E, N, D] against each edge's centres [E, K, D] ----

# (E, N, D, K, dtype): the compiled EL round's local step (4 edges of
# (128, 64, 3)); N not a multiple of a block; K = 1; wafer widths; bf16
KM_BATCHED = [(4, 128, 64, 3, "float32"), (3, 300, 64, 3, "float32"),
              (2, 100, 64, 1, "float32"), (2, 513, 59, 8, "float32"),
              (3, 300, 64, 3, "bfloat16")]


def _batched_inputs(e, n, d, k, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, n, d)).astype(np.float32)
    c = rng.standard_normal((e, k, d)).astype(np.float32)
    return (jnp.asarray(x, getattr(jnp, dtype)),
            jnp.asarray(c, getattr(jnp, dtype)),
            torch.tensor(x).to(getattr(torch, dtype)),
            torch.tensor(c).to(getattr(torch, dtype)))


@pytest.mark.parametrize("oracle", ["jnp_ref", "pallas_interpret"])
@pytest.mark.parametrize("e,n,d,k,dtype", KM_BATCHED)
def test_batched_plain_matches_reference_under_vmap(e, n, d, k, dtype,
                                                    oracle):
    """The wrapper's batched CPU path against the reference's kernel under
    ``jax.vmap`` over edges (interpret mode), as the compiled EL round
    runs it, and against its vmapped jnp oracle."""
    import jax
    jx, jc, tx, tc = _batched_inputs(e, n, d, k, dtype, seed=e + n + d + k)
    if oracle == "jnp_ref":
        a_ref, d2_ref = jax.vmap(jax_assign_ref)(jx, jc)
    else:
        a_ref, d2_ref = jax.vmap(lambda x, c: jax_assign_with_dist(
            x, c, interpret=True))(jx, jc)
    ops.batched_launches = 0
    a, d2 = ops.assign_with_dist_batched(tx, tc)
    assert ops.batched_launches == 0           # the CPU takes the plain path
    assert a.dtype == torch.int32 and d2.dtype == torch.float32
    assert a.shape == (e, n) and d2.shape == (e, n)
    rtol, atol = _tolerance(dtype)
    np.testing.assert_allclose(d2.numpy(), np.asarray(d2_ref),
                               rtol=rtol, atol=atol)
    if dtype == "float32":
        assert (a.numpy() == np.asarray(a_ref)).mean() >= 0.999
    if k == 1:
        assert not bool(a.any())


def test_batched_plain_equals_per_edge_plain():
    _, _, x, c = _batched_inputs(3, 200, 64, 3, "float32", seed=9)
    a, d2 = ref.assign_ref(x, c)
    for i in range(3):
        a_i, d2_i = ref.assign_ref(x[i], c[i])
        assert (a[i] == a_i).float().mean() >= 0.999
        torch.testing.assert_close(d2[i], d2_i, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("bad", ["rank", "edges", "width", "dtype",
                                 "no_centres"])
def test_batched_wrapper_rejects_malformed_inputs(bad):
    x = torch.zeros(2, 8, 4)
    c = torch.zeros(2, 3, 4)
    if bad == "rank":
        x = x[0]
    elif bad == "edges":
        c = torch.zeros(3, 3, 4)
    elif bad == "width":
        c = torch.zeros(2, 3, 5)
    elif bad == "dtype":
        x, c = x.double(), c.double()
    else:
        c = torch.zeros(2, 0, 4)
    with pytest.raises((ValueError, TypeError)):
        ops.assign_with_dist_batched(x, c)


def test_kmeans_step_takes_an_edge_dimension():
    """A batched Lloyd step ([E, B, D] against per-edge centres) equals
    each edge's own step."""
    model = KMeans(get_config("kmeans-traffic").model, device="cpu")
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.standard_normal((3, 128, 64)), dtype=torch.float32)
    c = torch.tensor(rng.standard_normal((3, 3, 64)), dtype=torch.float32)
    new = model.step({"centers": c}, {"x": x}, 1.0)["centers"]
    assert new.shape == (3, 3, 64)
    for i in range(3):
        one = model.step({"centers": c[i]}, {"x": x[i]}, 1.0)["centers"]
        torch.testing.assert_close(new[i], one, rtol=1e-6, atol=1e-6)
    assert model.assign({"centers": c}, x).shape == (3, 128)


# -- the batched entry under torch.func.vmap (a sweep's cells) -----------------


@pytest.mark.parametrize("in_dims", [(0, 0), (1, 1), (None, 0), (0, None)])
def test_batched_op_under_vmap_folds_cells_into_edges(in_dims):
    """``torch.func.vmap`` over the registered op: the vmap rule folds the
    cell dimension into the edge dimension (an unbatched operand
    expanded), calls the op once, and unfolds; the result is the plain
    version on the folded ``[C * E, ...]`` shapes, bit for bit."""
    cells, e, n, d, k = 5, 3, 40, 16, 4
    rng = np.random.default_rng(21)
    x = torch.tensor(rng.standard_normal((cells, e, n, d)),
                     dtype=torch.float32)
    c = torch.tensor(rng.standard_normal((cells, e, k, d)),
                     dtype=torch.float32)
    xs = x if in_dims[0] == 0 else (x[0] if in_dims[0] is None
                                    else x.transpose(0, 1))
    cs = c if in_dims[1] == 0 else (c[0] if in_dims[1] is None
                                    else c.transpose(0, 1))
    a, d2 = torch.func.vmap(ops.assign_with_dist_batched,
                            in_dims=in_dims)(xs, cs)
    assert a.shape == (cells, e, n) and a.dtype == torch.int32
    xf = (x[:1] if in_dims[0] is None else x).expand(cells, e, n, d)
    cf = (c[:1] if in_dims[1] is None else c).expand(cells, e, k, d)
    a_ref, d2_ref = ref.assign_ref(xf.reshape(-1, n, d),
                                   cf.reshape(-1, k, d))
    assert torch.equal(a.reshape(-1, n), a_ref)
    assert torch.equal(d2.reshape(-1, n), d2_ref)


def test_batched_op_under_nested_vmap_folds_one_dim_at_a_time():
    outer, inner, e, n, d, k = 2, 3, 4, 24, 8, 3
    rng = np.random.default_rng(22)
    x = torch.tensor(rng.standard_normal((outer, inner, e, n, d)),
                     dtype=torch.float32)
    c = torch.tensor(rng.standard_normal((outer, inner, e, k, d)),
                     dtype=torch.float32)
    a, d2 = torch.func.vmap(torch.func.vmap(ops.assign_with_dist_batched))(
        x, c)
    assert a.shape == (outer, inner, e, n)
    a_ref, d2_ref = ref.assign_ref(x.reshape(-1, n, d), c.reshape(-1, k, d))
    assert torch.equal(a.reshape(-1, n), a_ref)
    assert torch.equal(d2.reshape(-1, n), d2_ref)


def test_batched_op_is_registered_with_a_fake_implementation():
    """``repro_torch::kmeans_assign_batched`` is a registered op whose fake
    (meta) implementation gives the outputs' shapes and dtypes; the grid
    bound on (cell, edge) pairs is the kernel's ``gridDim.y``."""
    op = torch.ops.repro_torch.kmeans_assign_batched
    a, d2 = op(torch.empty(6, 10, 4, device="meta"),
               torch.empty(6, 3, 4, device="meta"))
    assert a.shape == d2.shape == (6, 10)
    assert (a.dtype, d2.dtype) == (torch.int32, torch.float32)
    assert ops.MAX_EDGES == 65_535

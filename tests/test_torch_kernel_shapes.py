"""Every shape the reference's kernels take, through the port's wrappers.

The port's CUDA kernels are built for fixed tiles; their wrappers reach
the rest of the reference's shapes by exact rewrites that need no card:
``flash_attention`` zero-pads a head dim up to the next instance (64, 128
or 256) and keeps the caller's 1/sqrt(D); ``ssd_scan`` runs a chunk above
128 rows as sub-chunks and, in bf16, pads P and N to multiples of 16;
``kmeans_assign`` walks centre sets larger than one block's shared memory
in tiles.  Here the plain versions, run through those rewrites on the
CPU, are held to the reference's oracles on numpy inputs at the reference
test's tolerances (2e-5 / 1e-4 in f32, 5e-2 in bf16), the plans are held
to the ones every shape the kernels took before keeps (no pad, the
caller's chunk, the same P tile, one tile of centres), and on stand-in
CUDA tensors the ops reach the (stubbed) kernel at the padded widths and
never the plain version.
"""

import functools
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import ops as jax_fa_ops  # noqa: E402
from repro.kernels.flash_attention import ref as jax_fa_ref  # noqa: E402
from repro.kernels.ssd_scan import ref as jax_ssd_ref  # noqa: E402
from repro_torch.config import MAMBA, get_config, get_smoke_config, \
    list_archs  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402,E501
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.kmeans_assign import kernel as km_kernel  # noqa: E402,E501
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as ssd_ref  # noqa: E402

H100_SMEM, H100_SMS = 232_448, 132


def _lm_configs():
    """Every LM config of the port, full and smoke."""
    for arch in list_archs():
        for get in (get_config, get_smoke_config):
            yield arch, get(arch).model


# -- flash_attention: any head dim up to 256 ----------------------------------

# (b, s, h, kv, d, window): head dims no instance has (16, 48: the 5m
# preset's 192 / 4, 80: Phi-2's, 96: Phi-3-mini's, 200), a window that
# starts mid-sequence, and GQA groups of 2 and 4
FLASH_PADDED = [(1, 64, 2, 2, 16, 0), (2, 64, 4, 4, 48, 0),
                (1, 64, 2, 2, 80, 0), (1, 64, 2, 2, 96, 0),
                (1, 64, 2, 2, 200, 0), (1, 64, 2, 2, 48, 16),
                (1, 64, 4, 2, 80, 0), (1, 64, 8, 2, 96, 24)]


def _flash_inputs(b, s, h, kv, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]


@pytest.mark.parametrize("b,s,h,kv,d,window", FLASH_PADDED)
def test_flash_padded_head_dim_matches_the_reference(b, s, h, kv, d, window):
    """``unpad(attention_ref(*pad_head_dim(q, k, v), scale=1/sqrt(D)))``,
    what the card's path computes on the padded instance, is the
    reference's attention at D, within its f32 tolerance."""
    arrs = _flash_inputs(b, s, h, kv, d, seed=d + window)
    q, k, v = (torch.from_numpy(a) for a in arrs)
    qp, kp, vp = fa_kernel.pad_head_dim(q, k, v)
    dp = fa_kernel.padded_head_dim(d)
    assert dp in fa_kernel.HEAD_DIMS and dp > d
    assert qp.shape[-1] == kp.shape[-1] == vp.shape[-1] == dp
    assert all(t.is_contiguous() for t in (qp, kp, vp))
    assert not any(bool(t[..., d:].any()) for t in (qp, kp, vp))
    out = fa_kernel.unpad(fa_ref.attention_ref(
        qp, kp, vp, causal=True, window=window, scale=1 / math.sqrt(d)), d)
    assert out.shape == (b, s, h, d) and out.is_contiguous()
    want = jax.jit(functools.partial(jax_fa_ref.attention_ref, causal=True,
                                     window=window))(
        *(jnp.asarray(a) for a in arrs))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_flash_padded_head_dim_matches_the_interpreted_kernel():
    """The 5m preset's head dim, 48, against the reference's Pallas kernel
    in interpret mode (which takes any D)."""
    arrs = _flash_inputs(2, 64, 4, 4, 48, seed=5)
    q, k, v = (torch.from_numpy(a) for a in arrs)
    out = fa_kernel.unpad(fa_ref.attention_ref(
        *fa_kernel.pad_head_dim(q, k, v), scale=1 / math.sqrt(48)), 48)
    want = jax_fa_ops.flash_attention(*(jnp.asarray(a) for a in arrs), True,
                                      0, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_flash_scale_default_is_the_plain_versions():
    """``scale`` left out divides by sqrt(D) as before, bit for bit."""
    q, k, v = (torch.from_numpy(a) for a in _flash_inputs(1, 32, 2, 2, 64, 3))
    assert torch.equal(fa_ref.attention_ref(q, k, v),
                       fa_ref.attention_ref(q, k, v, scale=None))


@pytest.mark.parametrize("d,want", [(1, 64), (48, 64), (64, 64), (65, 128),
                                    (96, 128), (128, 128), (129, 256),
                                    (200, 256), (256, 256)])
def test_flash_head_dim_plan(d, want):
    assert fa_kernel.padded_head_dim(d) == want


@pytest.mark.parametrize("d", [257, 512])
def test_flash_refuses_head_dims_past_256(d):
    """Past the largest tiled instance (256) nothing is refused: the wide
    instance takes D padded to a multiple of 64, and the meta trace
    allocates the padded copies and the caller's output."""
    assert fa_kernel.padded_head_dim(d) == -(-d // 64) * 64
    q = torch.zeros(1, 8, 2, d, device="meta")
    out = fa_ops.flash_attention(q, q, q)
    assert out.shape == (1, 8, 2, d) and out.device.type == "meta"


# (b, s, h, kv, d, window, dtype): the reference's FLASH_CASES
REF_FLASH_CASES = [(1, 128, 4, 4, 64, 0, "float32"),
                   (2, 256, 4, 2, 64, 0, "float32"),
                   (1, 256, 8, 1, 64, 0, "float32"),
                   (1, 128, 4, 4, 128, 0, "float32"),
                   (1, 128, 2, 2, 256, 0, "float32"),
                   (2, 256, 4, 2, 64, 128, "float32"),
                   (1, 256, 4, 4, 64, 64, "float32"),
                   (1, 128, 4, 2, 64, 0, "bfloat16")]


def _head_dims():
    dims = {c[4] for c in REF_FLASH_CASES}
    for _, m in _lm_configs():
        if any(kind != MAMBA for kind, _ in m.block_pattern()):
            dims.add(m.resolved_head_dim)
    return sorted(dims)


@pytest.mark.parametrize("d", _head_dims())
def test_flash_plan_unchanged_at_every_built_head_dim(d):
    """Every config's and the reference tests' head dims are instances:
    nothing is padded or copied."""
    assert d in fa_kernel.HEAD_DIMS and fa_kernel.padded_head_dim(d) == d
    q, k = torch.zeros(1, 4, 2, d), torch.zeros(1, 4, 1, d)
    got = fa_kernel.pad_head_dim(q, k, k)
    assert got[0] is q and got[1] is k and got[2] is k
    out = torch.zeros(1, 4, 2, d)
    assert fa_kernel.unpad(out, d) is out


def test_meta_flash_allocates_the_padded_copies():
    """On meta tensors the forward allocates the card path's padded
    copies and output (the planner's live bytes stay the card's) and
    counts the work at the caller's D."""
    q = torch.empty(2, 64, 4, 48, device="meta")
    before = (fa_ops.meta_flops, fa_ops.meta_bytes)
    out = fa_ops.flash_attention(q, q, q)
    assert out.shape == (2, 64, 4, 48) and out.device.type == "meta"
    flops, nbytes = fa_ops.work(2, 64, 4, 4, 48, 0, 4)
    assert (fa_ops.meta_flops - before[0], fa_ops.meta_bytes - before[1]) \
        == (flops, nbytes)


# -- ssd_scan: any chunk, any P, N up to 256 ----------------------------------

# (b, s, h, p, n, chunk, dtype, the plan's (P, N, chunk, P tile)): mamba2's
# public chunk of 256 (run as two chunks of 128), P = 48 (tile 16, no pad),
# P = 40 with N = 24 (padded to 48 and 32), N = 256 in bf16 (chunks of 64),
# the f32 (256, 256) block (chunks of 64), a chunk of 130 (chunks of 65)
SSD_PADDED = [
    (1, 256, 2, 64, 128, 256, "float32", (64, 128, 128, 64)),
    (1, 512, 2, 64, 128, 256, "bfloat16", (64, 128, 128, 32)),
    (1, 128, 2, 48, 128, 128, "bfloat16", (48, 128, 128, 16)),
    (1, 128, 2, 48, 16, 64, "float32", (48, 16, 64, 48)),
    (2, 128, 2, 40, 24, 64, "bfloat16", (48, 32, 64, 16)),
    (1, 128, 2, 64, 256, 128, "bfloat16", (64, 256, 64, 32)),
    (1, 128, 1, 256, 256, 128, "float32", (256, 256, 64, 64)),
    (1, 260, 2, 32, 16, 130, "bfloat16", (32, 16, 65, 16)),
]


def _ssd_inputs(b, s, h, p, n, dtype, seed):
    """The reference test's recipe drawn with numpy: x * softplus(dt) and
    B, C in ``dtype`` (rounded once, by ml_dtypes), da = dt * A in f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    cast = ((lambda v: v.astype(ml_dtypes.bfloat16)) if dtype == "bfloat16"
            else (lambda v: v))
    return cast(x * dt[..., None]), (dt * a).astype(np.float32), cast(bm), \
        cast(cm)


def _ssd_torch(arrays):
    return [torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16 if a.dtype == ml_dtypes.bfloat16 else torch.float32)
        for a in arrays]


@pytest.mark.parametrize("b,s,h,p,n,chunk,dtype,planned", SSD_PADDED)
def test_ssd_plan_on_padded_inputs_matches_the_reference(
        b, s, h, p, n, chunk, dtype, planned):
    """What the card's path computes: the inputs padded to the plan's
    widths, the scan at the plan's chunk, y and the state sliced back;
    held to the reference's oracle at the caller's chunk, by the rule the
    card's kernel is held to (``ref.allowed_error``): the reference
    test's tolerance plus twice the f32 rounding bound, since two
    chunkings sum in two orders (at chunk 256 against 128, N = 128, a few
    elements where sums cancel differ by 1.8e-4)."""
    run = ssd_kernel.plan(b, s, h, p, n, chunk, getattr(torch, dtype),
                          H100_SMEM, H100_SMS)
    assert (run.p, run.n, run.chunk, run.p_tile) == planned
    assert chunk % run.chunk == 0
    arrays = _ssd_inputs(b, s, h, p, n, dtype, seed=s + p + n)
    x, da, bm, cm = _ssd_torch(arrays)
    xp, bp, cp = ssd_kernel.pad_widths(x, bm, cm)
    assert xp.shape[-1] == run.p and bp.shape[-1] == cp.shape[-1] == run.n
    y, state = ssd_kernel.unpad(
        *ssd_ref.ssd_reference(xp, da, bp, cp, run.chunk), p, n)
    assert y.shape == (b, s, h, p) and state.shape == (b, h, p, n)
    y_want, st_want = jax.jit(jax_ssd_ref.ssd_reference, static_argnums=4)(
        *(jnp.asarray(a) for a in arrays), chunk)
    tol = 5e-2 if dtype == "bfloat16" else 1e-4
    bounds = ssd_ref.f32_rounding_bound(x, da, bm, cm, chunk)
    for got, want, bound in zip((y, state), (y_want, st_want), bounds):
        want = torch.from_numpy(np.asarray(want, np.float64))
        err = (got.double() - want).abs()
        assert bool((err <= tol + tol * want.abs() + 2 * bound).all()), \
            float(err.max())


# (b, s, h, p, n, chunk, dtype, P tile): every shape the kernel ran at
# before sub-chunks and padding, with the P tile its plan gave then: the
# reference's SSD_CASES, the card check's kernel-vs-plain cases, and the
# configs' SSM shapes (mamba2-370m's 32 heads of 64, jamba-1.5's 128 of
# 128, the smoke configs' 16 of 32) at batches of 1, 4 and 8
SSD_KEPT = [
    (2, 128, 4, 32, 16, 32, "float32", 32),
    (1, 256, 2, 64, 128, 128, "float32", 64),
    (1, 64, 8, 64, 64, 32, "float32", 64),
    (2, 128, 2, 128, 128, 64, "float32", 64),
    (1, 128, 4, 32, 16, 32, "bfloat16", 16),
    (4, 512, 32, 64, 128, 128, "bfloat16", 64),
    (4, 512, 32, 64, 128, 128, "float32", 64),
    (4, 640, 32, 64, 128, 128, "bfloat16", 64),
    (4, 100, 32, 64, 128, 100, "bfloat16", 64),
    (2, 100, 4, 64, 128, 100, "float32", 64),
    (1, 128, 32, 64, 128, 128, "bfloat16", 32),
    (5, 256, 32, 64, 128, 128, "bfloat16", 64),
    (2, 256, 8, 128, 128, 128, "bfloat16", 64),
    (1, 128, 136, 128, 32, 64, "bfloat16", 128),
    (2, 128, 70, 128, 128, 64, "bfloat16", 128),
    (2, 100, 4, 32, 16, 100, "bfloat16", 16),
    (8, 512, 32, 64, 128, 128, "bfloat16", 64),
    (4, 512, 128, 128, 128, 128, "bfloat16", 64),
    (4, 512, 128, 128, 128, 128, "float32", 64),
    (8, 512, 128, 128, 128, 128, "bfloat16", 64),
    (1, 128, 4, 32, 16, 128, "float32", 32),
    (1, 2048, 2, 64, 128, 128, "float32", 64),
    (1, 256, 1, 64, 128, 128, "float32", 64),
    (1, 90, 2, 30, 18, 45, "float32", 30),
    (1, 128, 2, 32, 256, 64, "float32", 32),
    (1, 512, 32, 64, 128, 128, "float32", 64),
    (8, 512, 32, 64, 128, 128, "float32", 64),
    (1, 512, 128, 128, 128, 128, "bfloat16", 64),
    (1, 512, 128, 128, 128, 128, "float32", 64),
    (8, 512, 128, 128, 128, 128, "float32", 64),
    (1, 128, 16, 32, 16, 32, "bfloat16", 16),
    (1, 128, 16, 32, 16, 32, "float32", 32),
    (4, 128, 16, 32, 16, 32, "bfloat16", 16),
    (4, 128, 16, 32, 16, 32, "float32", 32),
    (8, 128, 16, 32, 16, 32, "bfloat16", 32),
    (8, 128, 16, 32, 16, 32, "float32", 32),
]


@pytest.mark.parametrize("b,s,h,p,n,chunk,dtype,tile", SSD_KEPT)
def test_ssd_plan_unchanged_where_the_kernel_ran(b, s, h, p, n, chunk, dtype,
                                                 tile):
    """No pad, the caller's chunk and the P tile it had: the outputs of
    every shape the kernel took before do not change."""
    dt = getattr(torch, dtype)
    run = ssd_kernel.plan(b, s, h, p, n, chunk, dt, H100_SMEM, H100_SMS)
    assert (run.p, run.n, run.chunk, run.p_tile) == (p, n, chunk, tile)
    assert ssd_kernel.padded_widths(p, n, dt) == (p, n)
    x, b_mat = torch.zeros(1, 1, 1, p, dtype=dt), torch.zeros(1, 1, n,
                                                               dtype=dt)
    got = ssd_kernel.pad_widths(x, b_mat, b_mat)
    assert got[0] is x and got[1] is b_mat and got[2] is b_mat


def test_ssd_kept_table_holds_every_config_ssm_shape():
    """Each config with Mamba layers, at batches of 1, 4 and 8 in both
    dtypes, is a row of ``SSD_KEPT``."""
    kept = {(b, h, p, n, chunk, dt) for b, _, h, p, n, chunk, dt, _
            in SSD_KEPT}
    seen = 0
    for arch, m in _lm_configs():
        if not any(kind == MAMBA for kind, _ in m.block_pattern()):
            continue
        mc = m.mamba
        for b in (1, 4, 8):
            for dt in ("bfloat16", "float32"):
                shape = (b, mc.n_heads(m.d_model), mc.head_dim, mc.d_state,
                         mc.chunk_size, dt)
                assert shape in kept, (arch, shape)
                seen += 1
    assert seen >= 4 * 6          # mamba2-370m and jamba-1.5, full and smoke


@pytest.mark.parametrize("chunk,want", [(128, [128, 64, 32, 16, 8, 4, 2, 1]),
                                        (256, [128, 64, 32, 16, 8, 4, 2, 1]),
                                        (100, [100, 50, 25, 20, 10, 5, 4, 2,
                                               1]),
                                        (130, [65, 26, 13, 10, 5, 2, 1]),
                                        (131, [1])])
def test_ssd_sub_chunks_divide_the_callers(chunk, want):
    assert ssd_kernel.sub_chunks(chunk) == want


def test_ssd_pad_is_zero_columns():
    x = torch.ones(1, 4, 2, 40, dtype=torch.bfloat16)
    b_mat = torch.ones(1, 4, 24, dtype=torch.bfloat16)
    xp, bp, cp = ssd_kernel.pad_widths(x, b_mat, b_mat)
    assert xp.shape[-1] == 48 and bp.shape[-1] == cp.shape[-1] == 32
    assert not bool(xp[..., 40:].any()) and not bool(bp[..., 24:].any())
    assert torch.equal(xp[..., :40], x) and torch.equal(cp[..., :24], b_mat)
    # f32 takes any P and N as they are
    x32, b32 = x.float(), b_mat.float()
    got = ssd_kernel.pad_widths(x32, b32, b32)
    assert got[0] is x32 and got[1] is b32


def test_meta_ssd_allocates_the_padded_copies():
    """On meta tensors a bf16 call at P = 40, N = 24 returns the caller's
    widths and counts the work at them."""
    x = torch.empty(2, 128, 4, 40, dtype=torch.bfloat16, device="meta")
    da = torch.empty(2, 128, 4, device="meta")
    bm = torch.empty(2, 128, 24, dtype=torch.bfloat16, device="meta")
    before = (ssd_ops.meta_flops, ssd_ops.meta_bytes)
    y, state = ssd_ops.ssd(x, da, bm, bm, 128)
    assert y.shape == x.shape and state.shape == (2, 4, 40, 24)
    flops, nbytes = ssd_ops.work(2, 128, 4, 40, 24, 128, 2)
    assert (ssd_ops.meta_flops - before[0], ssd_ops.meta_bytes - before[1]) \
        == (flops, nbytes)


# -- kmeans_assign: centre sets larger than one block ----------------------------

# (n, d, k): the reference's KM_CASES and the paper's kmeans-traffic
# E-step (K = 3 centres of 64 features)
KM_KEPT = [(100, 8, 3), (1000, 64, 3), (513, 59, 8), (256, 16, 32),
           (300, 64, 3), (128, 64, 3)]


@pytest.mark.parametrize("n,d,k", KM_KEPT)
def test_kmeans_plan_keeps_one_tile(n, d, k):
    """Where all K centres fit a block, one tile of K: the kernel runs as
    it did, bit for bit."""
    run = km_kernel.plan(d, k, H100_SMEM)
    assert not run.block and run.tile == k
    assert run.group == km_kernel.lane_group(d)


def test_kmeans_traffic_config_keeps_one_tile():
    m = get_config("kmeans-traffic").model
    run = km_kernel.plan(m.d_model, m.vocab_size, H100_SMEM)
    assert not run.block and run.tile == m.vocab_size == 3


# (d, k): 1,000 centres of 64 and a 1,024-entry codebook at D = 128
# (beyond one block's shared memory), and points wider than a lane
# group's 256 registers' worth (4,096 features, with 100 or 14 centres)
@pytest.mark.parametrize("d,k", [(64, 1000), (128, 1024), (4096, 100),
                                 (4096, 14)])
def test_kmeans_plan_tiles_what_does_not_fit(d, k):
    """The block-tiled instance, tiles of ``BLOCK_CENTRES``, where the
    lane-group instance cannot hold the centres or the point."""
    run = km_kernel.plan(d, k, H100_SMEM)
    assert run.block and run.tile == km_kernel.BLOCK_CENTRES
    assert d > km_kernel.LANES_MAX_D \
        or km_kernel.smem_bytes(d, k) > H100_SMEM


# -- the op reaches the kernel at the new shapes, never the plain version -------

class FakeCuda(torch.Tensor):
    """A CPU tensor that says it lies on a CUDA device: drives the ops'
    card path to the (stubbed) launch without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake(*shape, dtype=torch.float32):
    return torch.zeros(*shape, dtype=dtype).as_subclass(FakeCuda)


@pytest.mark.parametrize("d", [16, 48, 96, 200])
def test_flash_op_launches_the_padded_instance(d, monkeypatch):
    calls = []
    monkeypatch.setattr(fa_kernel, "flash_fwd", lambda *a: calls.append(a))
    monkeypatch.setattr(fa_ops, "attention_ref", lambda *a, **k: pytest.fail(
        "plain attention ran for a CUDA tensor"))
    before = fa_ops.launches
    out = fa_ops.flash_attention(_fake(1, 64, 4, d), _fake(1, 64, 2, d),
                                 _fake(1, 64, 2, d), window=16)
    assert len(calls) == 1 and fa_ops.launches == before + 1
    q, k, v, causal, window, o, scale = calls[0]
    dp = fa_kernel.padded_head_dim(d)
    assert q.shape[-1] == k.shape[-1] == v.shape[-1] == o.shape[-1] == dp
    assert (causal, window) == (True, 16)
    assert scale == 1.0 / math.sqrt(d)
    assert out.shape == (1, 64, 4, d)


@pytest.mark.parametrize("p,n,chunk,dtype", [(48, 24, 64, torch.bfloat16),
                                             (64, 256, 256, torch.bfloat16),
                                             (256, 256, 128, torch.float32)])
def test_ssd_op_launches_at_the_padded_widths(p, n, chunk, dtype,
                                              monkeypatch):
    calls = []
    monkeypatch.setattr(ssd_kernel, "ssd_fwd", lambda *a: calls.append(a))
    monkeypatch.setattr(ssd_ops, "ssd_reference", lambda *a: pytest.fail(
        "plain SSD ran for a CUDA tensor"))
    monkeypatch.setattr(torch, "empty", lambda *s, **k: _fake(
        *s, dtype=k.get("dtype", torch.float32)))
    before = ssd_ops.launches
    y, state = ssd_ops.ssd(_fake(1, 256, 2, p, dtype=dtype),
                           _fake(1, 256, 2), _fake(1, 256, n, dtype=dtype),
                           _fake(1, 256, n, dtype=dtype), chunk)
    assert len(calls) == 1 and ssd_ops.launches == before + 1
    x, _, b_mat, c_mat, got_chunk, y_k, st_k = calls[0]
    pp, np_ = ssd_kernel.padded_widths(p, n, dtype)
    assert x.shape[-1] == y_k.shape[-1] == pp and got_chunk == chunk
    assert b_mat.shape[-1] == c_mat.shape[-1] == np_
    assert tuple(st_k.shape) == (1, 2, pp, np_)
    assert y.shape == (1, 256, 2, p) and state.shape == (1, 2, p, n)

"""The port's SSD scan op vs the JAX reference's.

The wrapper's CPU path (the plain torch ``ssd_reference``) is held to the
reference's jnp oracle and to its Pallas kernel in interpret mode, on the
same numpy inputs.  The CUDA kernel itself runs only on a card: its tests
are in ``test_torch_kernels_cuda.py``.
"""

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan.ops import ssd as jax_ssd  # noqa: E402
from repro.models import mamba2 as jax_m  # noqa: E402
from repro_torch.interop import tree_from_numpy  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel, ops, ref  # noqa: E402
from repro_torch.models import mamba2 as port_m  # noqa: E402

# (b, s, h, p, n, chunk, dtype): the reference's tests/test_kernels.py
# cases, then a ragged chunk (a 100-token prompt gives L=100)
SSD_CASES = [
    (2, 128, 4, 32, 16, 32, "float32"),
    (1, 256, 2, 64, 128, 128, "float32"),
    (1, 64, 8, 64, 64, 32, "float32"),
    (2, 128, 2, 128, 128, 64, "float32"),
    (1, 128, 4, 32, 16, 32, "bfloat16"),
    (1, 100, 4, 32, 16, 100, "float32"),
    (2, 100, 4, 64, 128, 100, "bfloat16"),
]


def _inputs(b, s, h, p, n, dtype, seed):
    """The reference test's recipe drawn with numpy, as numpy arrays both
    frameworks take bit for bit: x * softplus(dt) and B, C in ``dtype``
    (rounded once, by ml_dtypes), da = dt * A in f32."""
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


def _tol(dtype):
    # the reference test's tolerances: f32 sums in another order; bf16 y
    # rounded once on each side
    return 5e-2 if dtype == "bfloat16" else 1e-4


def _close(port, ref_arr, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref_arr, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("oracle", ["jnp_ref", "pallas_interpret"])
@pytest.mark.parametrize("b,s,h,p,n,chunk,dtype", SSD_CASES)
def test_plain_matches_reference(b, s, h, p, n, chunk, dtype, oracle):
    arrays = _inputs(b, s, h, p, n, dtype, seed=s * h + p)
    jx = [jnp.asarray(a) for a in arrays]
    if oracle == "jnp_ref":
        y_ref, st_ref = jax_m.ssd_reference(*jx, chunk)
    else:
        y_ref, st_ref = jax_ssd(*jx, chunk, True)
    before = ops.launches
    y, st = ops.ssd(*tree_from_numpy(list(arrays), "cpu"), chunk)
    assert ops.launches == before            # the CPU path launches nothing
    assert y.dtype == getattr(torch, dtype) and st.dtype == torch.float32
    _close(y, y_ref, _tol(dtype))
    _close(st, st_ref, _tol(dtype))


def test_padded_input_matches_reference():
    """The mixer's padding: a 40-step sequence under chunk 32 padded to 64
    with x = 0, da = 0, B = C = 0; the state and the first 40 outputs
    equal an unpadded single-chunk run of the reference."""
    x, da, bm, cm = _inputs(2, 40, 4, 32, 16, "float32", seed=4)
    pad = ((0, 0), (0, 24))
    padded = [np.pad(x, pad + ((0, 0), (0, 0))), np.pad(da, pad + ((0, 0),)),
              np.pad(bm, pad + ((0, 0),)), np.pad(cm, pad + ((0, 0),))]
    y, st = ops.ssd(*tree_from_numpy(padded, "cpu"), 32)
    y_ref, st_ref = jax_ssd(*[jnp.asarray(a) for a in padded], 32, True)
    _close(y, y_ref, 1e-4)
    _close(st, st_ref, 1e-4)
    y40, st40 = jax_m.ssd_reference(*[jnp.asarray(a) for a in
                                      (x, da, bm, cm)], 40)
    _close(y[:, :40], y40, 1e-4)
    _close(st, st40, 1e-4)


def test_segsum_matches_reference():
    v = np.random.default_rng(0).standard_normal((3, 2, 17)).astype(
        np.float32)
    out = ref.segsum(torch.from_numpy(v))
    want = np.asarray(jax_m.segsum(jnp.asarray(v)))
    assert np.array_equal(np.isneginf(out.numpy()), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(out.numpy()[fin], want[fin], atol=1e-5,
                               rtol=1e-5)


def test_recurrent_step_matches_reference():
    rng = np.random.default_rng(1)
    b, h, p, n = 2, 3, 8, 5
    arrays = [rng.standard_normal(sh).astype(np.float32)
              for sh in ((b, h, p, n), (b, h, p), (b, h), (b, n), (b, n))]
    arrays[2] = -np.abs(arrays[2])
    y, st = port_m.ssd_recurrent_step(*tree_from_numpy(arrays, "cpu"))
    y_ref, st_ref = jax_m.ssd_recurrent_step(*[jnp.asarray(a)
                                               for a in arrays])
    _close(y, y_ref, 1e-5)
    _close(st, st_ref, 1e-5)


def test_chunked_state_matches_recurrence():
    """Chunked SSD final state and outputs == the step-by-step recurrence
    (the reference's test_ssd_state_matches_recurrence, inside the port)."""
    b, s, h, p, n = 1, 64, 2, 16, 8
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(np.float32))
    da = -torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((b, s, h)).astype(np.float32)))
    bm = torch.from_numpy(rng.standard_normal((b, s, n)).astype(np.float32))
    cm = torch.from_numpy(rng.standard_normal((b, s, n)).astype(np.float32))
    y_chunked, state_chunked = ops.ssd(x, da, bm, cm, 16)
    state = torch.zeros(b, h, p, n)
    ys = []
    for t in range(s):
        y_t, state = port_m.ssd_recurrent_step(state, x[:, t], da[:, t],
                                               bm[:, t], cm[:, t])
        ys.append(y_t)
    torch.testing.assert_close(state_chunked, state, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(y_chunked, torch.stack(ys, dim=1), atol=1e-4,
                               rtol=1e-4)


def test_ssd_rejects_bad_inputs():
    x, da, bm, cm = tree_from_numpy(
        list(_inputs(1, 64, 2, 16, 8, "float32", seed=0)), "cpu")
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.ssd(x, da, bm, cm, 48)
    with pytest.raises(ValueError, match="disagree"):
        ops.ssd(x, da[:, :32], bm, cm, 32)
    with pytest.raises(TypeError, match="share dtype"):
        ops.ssd(x, da, bm.to(torch.bfloat16), cm, 32)
    with pytest.raises(TypeError, match="da must be float32"):
        ops.ssd(x, da.double(), bm, cm, 32)
    with pytest.raises(ValueError, match="x \\[B,S,H,P\\]"):
        ops.ssd(x[0], da, bm, cm, 32)


H100_SMEM, H100_SMS = 232448, 132


# (P, N, L, dtype, P tile, bytes): f32 the larger of its diagonal and
# carry blocks (the diagonal block at this shape); bf16 two stages of x
# [Lp, Pt+8], B and C [Lp, N+8] (bf16) and da [Lp], the state's hi and lo
# parts [Pt, N+8] and five small f32 vectors
@pytest.mark.parametrize("p,n,chunk,dtype,tile,want", [
    (64, 128, 128, "float32", None, 210944),
    (64, 128, 128, "bfloat16", 64, 214048),
    (64, 128, 128, "bfloat16", 32, 180256),
    (32, 16, 32, "bfloat16", 16, 11552),
    (64, 128, 100, "bfloat16", 64, 191648),
])
def test_smem_plan_by_dtype(p, n, chunk, dtype, tile, want):
    assert kernel.smem_bytes(p, n, chunk, getattr(torch, dtype),
                             tile) == want


# (B, H, P, N, L, dtype, P tile): bf16 halves P only where twice B * H
# blocks still fit one wave of the card's 132 SMs, and takes the other
# tile where the first does not fit its shared memory; f32 keeps P
@pytest.mark.parametrize("b,h,p,n,chunk,dtype,tile", [
    (4, 32, 64, 128, 128, "bfloat16", 64),     # the serving prefill
    (1, 32, 64, 128, 128, "bfloat16", 32),     # a lone admitted prompt
    (5, 32, 64, 128, 128, "bfloat16", 64),
    (2, 8, 128, 128, 128, "bfloat16", 64),     # P = 128 does not fit
    (8, 32, 128, 128, 128, "bfloat16", 64),
    (1, 136, 128, 32, 64, "bfloat16", 128),
    (1, 4, 32, 16, 32, "bfloat16", 16),
    (1, 4, 16, 16, 32, "bfloat16", 16),        # no tile of 8
    (4, 32, 64, 128, 128, "float32", 64),
    (4, 128, 128, 128, 128, "float32", 64),    # two carry blocks a head
    (3, 4, 32, 16, 32, "float32", 32),
])
def test_p_tile_choice(b, h, p, n, chunk, dtype, tile):
    run = kernel.plan(b, 4 * chunk, h, p, n, chunk, getattr(torch, dtype),
                      H100_SMEM, H100_SMS)
    assert (run.p, run.n, run.chunk, run.p_tile) == (p, n, chunk, tile)


# (P tile, N, items a warp holds): 8 warps share the P tile's 16-row
# slices, each slice's 32-column groups split among its warps
@pytest.mark.parametrize("tile,n,items", [(16, 128, 1), (32, 128, 1),
                                          (64, 128, 2), (128, 128, 4),
                                          (128, 32, 1), (64, 256, 4),
                                          (16, 16, 1)])
def test_state_items(tile, n, items):
    assert kernel.state_items(tile, n) == items


# (P, N, L, dtype, words the refusal names): past 256 state columns, the
# one limit left, in both dtypes (every other shape is planned: padded,
# sub-chunked, on a smaller P tile; tests/test_torch_kernel_shapes.py)
@pytest.mark.parametrize("p,n,chunk,dtype,words", [
    (32, 512, 64, "bfloat16", "256 state columns"),
    (40, 272, 64, "bfloat16", "256 state columns"),
    (64, 257, 128, "bfloat16", "256 state columns"),
    (512, 1024, 32, "bfloat16", "256 state columns"),
    (128, 512, 16, "float32", "256 state columns"),
    (256, 264, 128, "float32", "256 state columns"),
    (32, 512, 256, "float32", "256 state columns"),
])
def test_p_tile_refusals_name_the_limit(p, n, chunk, dtype, words):
    with pytest.raises(ValueError, match=words):
        kernel.plan(1, 4 * chunk, 2, p, n, chunk, getattr(torch, dtype),
                    H100_SMEM, H100_SMS)


# (P, N, L, diagonal block bytes, carry block bytes): the f32 instance's
# two kernels.  Diagonal: G [Lp, Lp+4], then C and B [Lp, N4+4] or Gd
# [Lp, Lp+4] and two x slabs [Lp, 64] in the same bytes, and da / a_cs of
# up to 16 heads [16, Lp].  Carry: C and B [Lp, Np+4] (N padded to 64, 128
# or 256), x's tile [Lp, 64], the state [64, Np+4] and four [Lp] vectors.
@pytest.mark.parametrize("p,n,chunk,diag,carry", [
    (64, 128, 128, 210944, 203776),      # mamba2-370m
    (128, 128, 128, 210944, 203776),     # jamba-1.5
    (64, 128, 100, 177408, 182528),      # a 100-token prompt: Lp = 112
    (32, 16, 32, 27648, 43520),          # the smoke config
    (30, 18, 45, 47616, 56576),          # neither P nor N a multiple of 4
    (32, 256, 64, 154624, 217088),       # N = 256 at L = 64
])
def test_f32_smem_plan(p, n, chunk, diag, carry):
    assert kernel.f32_diag_smem(n, chunk) == diag
    assert kernel.f32_carry_smem(n, chunk) == carry
    assert kernel.smem_bytes(p, n, chunk, torch.float32) == max(diag, carry)
    assert max(diag, carry) <= H100_SMEM


# (B, S, H, P, N, L, heads a diagonal block takes): the fewest waves of
# 132 SMs times (N + heads P), G formed once per block, 16 heads at most
@pytest.mark.parametrize("b,s,h,p,n,chunk,hg", [
    (4, 512, 32, 64, 128, 128, 4),       # mamba2-370m serving: 128 blocks
    (8, 512, 32, 64, 128, 128, 8),       # its training shape
    (4, 512, 128, 128, 128, 128, 16),    # jamba-1.5: 128 blocks
    (1, 128, 4, 32, 16, 32, 1),          # a few blocks: one head each
    (1, 128, 1, 64, 128, 128, 1),        # B * H = 1
    (4, 512, 256, 128, 128, 128, 16),    # 32 would make one wave: capped
])
def test_f32_heads_per_block(b, s, h, p, n, chunk, hg):
    assert kernel.f32_heads_per_block(b, s, h, p, n, chunk, H100_SMS) == hg


def test_meta_forward_plans_no_scratch():
    """The f32 kernels take no scratch (kernel 1 writes y's diagonal part,
    kernel 2 adds the carried state's): the shape-only trace allocates the
    outputs alone and counts ``ops.work``."""
    before = (ops.meta_flops, ops.meta_bytes)
    x = torch.empty(4, 512, 32, 64, device="meta")
    da = torch.empty(4, 512, 32, device="meta")
    bm = torch.empty(4, 512, 128, device="meta")
    y, state = ops.ssd(x, da, bm, bm, 128)
    assert y.shape == x.shape and tuple(state.shape) == (4, 32, 64, 128)
    flops, nbytes = ops.work(4, 512, 32, 64, 128, 128, 4)
    assert (ops.meta_flops - before[0], ops.meta_bytes - before[1]) == \
        (flops, nbytes)

"""The port's flash-attention op on the CPU vs the reference's.

On the CPU the op runs its plain version ``ref.attention_ref``; it is held
to the reference's oracle ``attention_ref`` and to the reference's Pallas
kernel in interpret mode, on the reference test's cases
(``tests/test_kernels.py::FLASH_CASES``) at its tolerances (2e-5 f32,
2e-2 bf16), and its gradients (through the ``autograd.Function``, whose
backward re-runs the plain version) to ``jax.grad`` through the
reference's ``custom_vjp`` at 1e-4.  Inputs are drawn with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import ops as jax_ops  # noqa: E402
from repro.kernels.flash_attention import ref as jax_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ops, ref  # noqa: E402,E501

# (b, s, h, kv, d, window, dtype): the reference's FLASH_CASES
FLASH_CASES = [
    (1, 128, 4, 4, 64, 0, "float32"),
    (2, 256, 4, 2, 64, 0, "float32"),
    (1, 256, 8, 1, 64, 0, "float32"),      # MQA
    (1, 128, 4, 4, 128, 0, "float32"),
    (1, 128, 2, 2, 256, 0, "float32"),     # gemma head_dim
    (2, 256, 4, 2, 64, 128, "float32"),    # sliding window
    (1, 256, 4, 4, 64, 64, "float32"),     # small window
    (1, 128, 4, 2, 64, 0, "bfloat16"),
]


def _inputs(b, s, h, kv, d, dtype, seed):
    """numpy f32 draws, rounded to ``dtype``; returned as f32 numpy (the
    exact values both packages receive) plus the dtype name."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]
    if dtype == "bfloat16":
        arrs = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                for a in arrs]
    return arrs


def _jax(arrs, dtype):
    return [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


def _np(t):
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor)
                      else np.asarray(t, np.float32))


@pytest.mark.parametrize("b,s,h,kv,d,window,dtype", FLASH_CASES)
def test_op_matches_reference_oracle_and_kernel(b, s, h, kv, d, window,
                                                dtype):
    arrs = _inputs(b, s, h, kv, d, dtype, seed=s + h + d + window)
    q, k, v = _torch(arrs, dtype)
    before = ops.launches
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    assert ops.launches == before          # the CPU path launches nothing
    assert out.dtype == q.dtype and out.shape == q.shape
    jq, jk, jv = _jax(arrs, dtype)
    want_ref = jax_ref.attention_ref(jq, jk, jv, causal=True, window=window)
    want_kernel = jax_ops.flash_attention(jq, jk, jv, True, window, True)
    tol = ref.tolerance(q.dtype)
    for want in (want_ref, want_kernel):
        np.testing.assert_allclose(_np(out), _np(want), atol=tol, rtol=tol)


def test_tolerance_is_the_reference_tests():
    assert ref.tolerance(torch.float32) == 2e-5
    assert ref.tolerance(torch.bfloat16) == 2e-2


@pytest.mark.parametrize("s,window", [(300, 0), (300, 64), (77, 0)])
def test_ragged_sequence_matches_reference_oracle(s, window):
    """Any S: the port has no S % 128 rule (the reference kernel has)."""
    arrs = _inputs(2, s, 4, 2, 64, "float32", seed=s)
    out = ops.flash_attention(*_torch(arrs, "float32"), causal=True,
                              window=window)
    want = jax_ref.attention_ref(*_jax(arrs, "float32"), causal=True,
                                 window=window)
    np.testing.assert_allclose(_np(out), _np(want), atol=2e-5, rtol=2e-5)


def test_non_causal_matches_reference_kernel():
    arrs = _inputs(1, 128, 4, 2, 64, "float32", seed=3)
    out = ops.flash_attention(*_torch(arrs, "float32"), causal=False)
    want = jax_ops.flash_attention(*_jax(arrs, "float32"), False, 0, True)
    np.testing.assert_allclose(_np(out), _np(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("b,s,h,kv,d,window", [(1, 128, 2, 2, 64, 0),
                                               (2, 128, 4, 2, 64, 32)])
def test_grad_matches_reference_custom_vjp(b, s, h, kv, d, window):
    arrs = _inputs(b, s, h, kv, d, "float32", seed=b + window)

    def f(q, k, v):
        return jnp.sum(jax_ops.flash_attention(q, k, v, True, window,
                                               True) ** 2)

    want = jax.grad(f, argnums=(0, 1, 2))(*_jax(arrs, "float32"))
    qkv = [t.requires_grad_() for t in _torch(arrs, "float32")]
    loss = (ops.flash_attention(*qkv, causal=True, window=window) ** 2).sum()
    got = torch.autograd.grad(loss, qkv)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-4, rtol=1e-4)


def test_op_checks_its_inputs():
    q, k, v = _torch(_inputs(1, 16, 4, 2, 64, "float32", 0), "float32")
    with pytest.raises(ValueError, match="shapes disagree"):
        ops.flash_attention(q, k[:, :, :1].expand(1, 16, 3, 64), v)
    with pytest.raises(ValueError, match="shapes disagree"):
        ops.flash_attention(q, k, v[:, :8])
    with pytest.raises(TypeError, match="dtype"):
        ops.flash_attention(q, k.double(), v)
    with pytest.raises(TypeError, match="dtype"):
        ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match=r"\[B,S,H,D\]"):
        ops.flash_attention(q[0], k, v)


# the .cu's dynamic shared memory per block: bf16 (tensor cores) holds the
# query tile and two stages of key and value tiles, bf16 rows padded to
# D + 8; f32 (CUDA cores) the query tile (128 rows, 64 at D = 256) and one
# key and one value tile of 64 rows, f32 rows padded to D + 4
SMEM_PLAN = [("bfloat16", 64, 46_080), ("bfloat16", 128, 87_040),
             ("bfloat16", 256, 168_960), ("float32", 64, 69_632),
             ("float32", 128, 135_168), ("float32", 256, 199_680)]
H100_SMEM_PER_BLOCK = 232_448       # cudaDevAttrMaxSharedMemoryPerBlockOptin


@pytest.mark.parametrize("dtype,d,want", SMEM_PLAN)
def test_smem_plan_fits_the_card(dtype, d, want):
    """Every instance the .cu has fits one H100 block; no card needed."""
    dt = getattr(torch, dtype)
    got = kernel.smem_bytes(d, dt)
    assert got == want
    assert got <= H100_SMEM_PER_BLOCK
    assert kernel.smem_bytes(2 * kernel.HEAD_DIMS[-1], dt) \
        > H100_SMEM_PER_BLOCK


# (dtype, D, query rows per block, keys per tile)
@pytest.mark.parametrize("dtype,d,bq,bk", [
    ("bfloat16", 64, 64, 64), ("bfloat16", 256, 64, 64),
    ("float32", 64, 128, 64), ("float32", 128, 128, 64),
    ("float32", 256, 64, 64)])
def test_tiles_by_instance(dtype, d, bq, bk):
    assert kernel.tiles(d, getattr(torch, dtype)) == (bq, bk)


def test_cpu_runs_the_plain_version_and_never_launches(monkeypatch):
    calls = []

    def counted(*args, **kw):
        calls.append(kw)
        return ref.attention_ref(*args, **kw)

    monkeypatch.setattr(ops, "attention_ref", counted)
    monkeypatch.setattr(kernel, "flash_fwd", lambda *a, **k: pytest.fail(
        "the kernel was launched for a CPU tensor"))
    q, k, v = _torch(_inputs(1, 64, 4, 2, 64, "bfloat16", 1), "bfloat16")
    before = ops.launches
    out = ops.flash_attention(q, k, v, causal=True, window=16)
    assert ops.launches == before
    assert calls == [{"causal": True, "window": 16}]
    torch.testing.assert_close(out, ref.attention_ref(q, k, v, causal=True,
                                                      window=16),
                               rtol=0, atol=0)

"""float16 in the port's kernels, and the shapes past their old limits.

Every op takes float16 as the reference's kernels do, and every shape:
``flash_attention`` past head dim 256 on the wide instance (D zero-padded
to a multiple of 64, the caller's 1/sqrt(D) kept), ``ssd_scan`` past 256
state columns as parts of at most 256 (y summed over the parts in f32 and
rounded once, the final states side by side), ``kmeans_assign`` past 256
features and past one block's centres on the block-tiled instance.  Here,
on the CPU: each op at float16 against the reference's kernel in
interpret mode, at the port's float16 tolerance (``ref.tolerance``: the
bf16 bound); the new shapes computed the way the card's path computes
them, through the plain versions, against the reference's oracles; on
stand-in CUDA tensors, each op reaching the (stubbed) library at the
instance, widths and parts its plan gives, never the plain version; and a
float16 LM and Mamba-2 mixer against the reference's.
"""

import dataclasses
import functools
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import config as jax_config  # noqa: E402
from repro.kernels.flash_attention import ops as jax_fa_ops  # noqa: E402
from repro.kernels.flash_attention import ref as jax_fa_ref  # noqa: E402
from repro.kernels.kmeans_assign import ops as jax_km_ops  # noqa: E402
from repro.kernels.kmeans_assign import ref as jax_km_ref  # noqa: E402
from repro.kernels.ssd_scan import ops as jax_ssd_ops  # noqa: E402
from repro.kernels.ssd_scan import ref as jax_ssd_ref  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import mamba2 as jax_m  # noqa: E402
from repro_torch import config as port_config  # noqa: E402
from repro_torch.interop import tree_map, tree_to_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402,E501
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.kmeans_assign import kernel as km_kernel  # noqa: E402,E501
from repro_torch.kernels.kmeans_assign import ops as km_ops  # noqa: E402
from repro_torch.kernels.kmeans_assign import ref as km_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as ssd_ref  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import mamba2 as port_m  # noqa: E402

H100_SMEM, H100_SMS = 232_448, 132
NP_DTYPE = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16,
            "float16": np.float16}


def _cast(a, dtype):
    """``a`` rounded once to ``dtype`` (numpy), and as a torch tensor."""
    r = a.astype(NP_DTYPE[dtype])
    return r, torch.from_numpy(np.asarray(r, np.float32)).to(
        getattr(torch, dtype))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float() if torch.is_tensor(got)
                                          else got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# -- each op at float16 against the reference's interpreted kernel ------------


def test_tolerances_by_dtype():
    """float16 starts from the bf16 bounds of the reference's kernel
    tests, tightened as far as the card showed they hold: attention 1e-2
    (bf16 2e-2), SSD the bf16 bound, K-means f32's (f16 is exact in
    f32)."""
    assert fa_ref.tolerance(torch.float16) == 1e-2
    assert fa_ref.tolerance(torch.bfloat16) == 2e-2
    assert ssd_ref.tolerance(torch.float16) == ssd_ref.tolerance(
        torch.bfloat16) == 5e-2
    assert km_ref.tolerance(torch.float16) == km_ref.tolerance(
        torch.float32) == (1e-4, 1e-3)
    assert km_ref.tolerance(torch.bfloat16) == (1e-2, 1e-2)
    assert fa_ref.tolerance(torch.float32) == 2e-5
    assert ssd_ref.tolerance(torch.float32) == 1e-4
    assert km_ref.tolerance(torch.float32) == (1e-4, 1e-3)


@pytest.mark.parametrize("window,kv", [(16, 2)])
def test_flash_float16_matches_the_interpreted_kernel(window, kv):
    """A GQA group of 2 with a window of 16."""
    rng = np.random.default_rng(window)
    (q, qt), (k, kt), (v, vt) = (_cast(rng.standard_normal(s).astype(
        np.float32), "float16") for s in ((1, 64, 4, 64), (1, 64, kv, 64),
                                          (1, 64, kv, 64)))
    out = fa_ops.flash_attention(qt, kt, vt, window=window)
    assert out.dtype == torch.float16
    want = jax_fa_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), True, window, True)
    _close(out, want, fa_ref.tolerance(torch.float16))


def _ssd_arrays(b, s, h, p, n, seed):
    """The reference test's recipe drawn with numpy, in f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    return x * dt[..., None], (dt * a).astype(np.float32), bm, cm


def _ssd_cast(arrays, dtype):
    x, da, bm, cm = arrays
    (xn, xt), (bn, bt), (cn, ct) = (_cast(a, dtype) for a in (x, bm, cm))
    return (xn, da, bn, cn), (xt, torch.from_numpy(da), bt, ct)


def test_ssd_float16_matches_the_interpreted_kernel():
    arrays, (x, da, bm, cm) = _ssd_cast(_ssd_arrays(1, 64, 2, 32, 16, 3),
                                        "float16")
    y, state = ssd_ops.ssd(x, da, bm, cm, 32)
    assert y.dtype == torch.float16 and state.dtype == torch.float32
    y_want, st_want = jax_ssd_ops.ssd(*(jnp.asarray(a) for a in arrays), 32,
                                      True)
    tol = ssd_ref.tolerance(torch.float16)
    _close(y, y_want, tol)
    _close(state, st_want, tol)


def test_kmeans_float16_matches_the_interpreted_kernel():
    rng = np.random.default_rng(4)
    (x, xt), (c, ct) = (_cast(rng.standard_normal(s).astype(np.float32),
                              "float16") for s in ((100, 8), (3, 8)))
    a, d2 = km_ops.assign_with_dist(xt, ct)
    a_want, d2_want = jax_km_ops.assign_with_dist(jnp.asarray(x),
                                                  jnp.asarray(c),
                                                  interpret=True)
    rtol, atol = km_ref.tolerance(torch.float16)
    np.testing.assert_allclose(d2.numpy(), np.asarray(d2_want), rtol=rtol,
                               atol=atol)
    assert float((a.numpy() == np.asarray(a_want)).mean()) >= 0.99


# -- the new shapes, as the card's path computes them -------------------------

# (b, s, h, kv, d, window, dtype): the wide instance's head dims, padded
# to multiples of 64 (300 to 320), with windows and GQA groups
FLASH_WIDE = [(1, 64, 4, 2, 320, 16, "float32"),
              (1, 64, 4, 1, 512, 0, "float16"),
              (1, 64, 2, 1, 300, 24, "bfloat16")]


@pytest.mark.parametrize("b,s,h,kv,d,window,dtype", FLASH_WIDE)
def test_flash_wide_head_dim_matches_the_reference(b, s, h, kv, d, window,
                                                   dtype):
    rng = np.random.default_rng(d + window)
    pairs = [_cast(rng.standard_normal(shape).astype(np.float32), dtype)
             for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]
    qp, kp, vp = fa_kernel.pad_head_dim(*(t for _, t in pairs))
    dp = fa_kernel.padded_head_dim(d)
    assert dp == -(-d // 64) * 64 and fa_kernel.wide(dp)
    assert qp.shape[-1] == dp
    out = fa_kernel.unpad(fa_ref.attention_ref(
        qp, kp, vp, window=window, scale=1 / math.sqrt(d)), d)
    want = jax.jit(functools.partial(jax_fa_ref.attention_ref, causal=True,
                                     window=window))(
        *(jnp.asarray(a) for a, _ in pairs))
    _close(out, want, fa_ref.tolerance(getattr(torch, dtype)))


def _ssd_in_parts(x, da, bm, cm, chunk):
    """What the card's path computes past 256 state columns: B and C
    padded as ``pad_widths`` pads them, each part of ``kernel.plans`` at
    its chunk with y in f32, y summed over the parts in order and
    rounded once to x's dtype, the states side by side."""
    b, s, h, p = x.shape
    n = bm.shape[-1]
    xp, bp, cp = ssd_kernel.pad_widths(x, bm, cm)
    runs = ssd_kernel.plans(b, s, h, p, n, chunk, x.dtype, H100_SMEM,
                            H100_SMS)
    assert len(runs) > 1 and runs[-1][1] == bp.shape[-1]
    y32, states = None, []
    for n0, n1, run in runs:
        y_part, st = ssd_ref.ssd_reference(
            xp.float(), da, bp[..., n0:n1].float(), cp[..., n0:n1].float(),
            run.chunk)
        y32 = y_part if y32 is None else y32 + y_part
        states.append(st)
    return ssd_kernel.unpad(y32.to(x.dtype), torch.cat(states, -1), p, n)


# (b, s, h, p, n, chunk, dtype): 512 state columns (two parts of 256) in
# f32 and bf16, and 320 (two of 160) in f16 (two shapes, so the
# reference's eager ops compile twice, not once a case)
SSD_WIDE = [(1, 64, 2, 32, 512, 32, "float32"),
            (1, 64, 2, 32, 512, 32, "bfloat16"),
            (1, 64, 2, 32, 320, 32, "float16")]


@pytest.mark.parametrize("b,s,h,p,n,chunk,dtype", SSD_WIDE)
def test_ssd_wide_state_matches_the_reference(b, s, h, p, n, chunk, dtype):
    """Held as the card's kernel is (``ref.allowed_error``'s rule): the
    tolerance plus twice the f32 rounding bound, since the parts sum in
    another order."""
    arrays, (x, da, bm, cm) = _ssd_cast(_ssd_arrays(b, s, h, p, n, n + p),
                                        dtype)
    y, state = _ssd_in_parts(x, da, bm, cm, chunk)
    assert y.dtype == x.dtype and y.shape == x.shape
    assert state.shape == (b, h, p, n)
    y_want, st_want = jax.jit(jax_ssd_ref.ssd_reference, static_argnums=4)(
        *(jnp.asarray(a) for a in arrays), chunk)
    tol = ssd_ref.tolerance(x.dtype)
    bounds = ssd_ref.f32_rounding_bound(x, da, bm, cm, chunk)
    for got, want, bound in zip((y, state), (y_want, st_want), bounds):
        want = torch.from_numpy(np.asarray(want, np.float64))
        err = (got.double() - want).abs()
        assert bool((err <= tol + tol * want.abs() + 2 * bound).all()), \
            float(err.max())


@pytest.mark.parametrize("n,d,k,dtype", [(32, 8192, 3, "float32"),
                                         (40, 5000, 70, "float16")])
def test_kmeans_wide_points_match_the_reference(n, d, k, dtype):
    rng = np.random.default_rng(d + k)
    (x, xt), (c, ct) = (_cast(rng.standard_normal(s).astype(np.float32),
                              dtype) for s in ((n, d), (k, d)))
    assert km_kernel.plan(d, k, H100_SMEM).block
    a, d2 = km_ref.assign_ref(xt, ct)
    a_want, d2_want = jax.jit(jax_km_ref.assign_ref)(jnp.asarray(x),
                                                     jnp.asarray(c))
    rtol, atol = km_ref.tolerance(xt.dtype)
    np.testing.assert_allclose(d2.numpy(), np.asarray(d2_want), rtol=rtol,
                               atol=atol)
    assert np.array_equal(a.numpy(), np.asarray(a_want))


# -- plans --------------------------------------------------------------------


@pytest.mark.parametrize("d,want", [(257, 320), (300, 320), (320, 320),
                                    (512, 512), (513, 576), (1000, 1024)])
def test_flash_head_dims_past_256_pad_to_the_wide_slices(d, want):
    assert fa_kernel.padded_head_dim(d) == want and fa_kernel.wide(want)
    assert fa_kernel.smem_bytes(want, torch.bfloat16) == fa_kernel.smem_bytes(
        want, torch.float32) == 101_376 <= H100_SMEM


@pytest.mark.parametrize("n,dtype,parts", [
    (256, "bfloat16", [(0, 256)]), (320, "float16", [(0, 160), (160, 320)]),
    (512, "bfloat16", [(0, 256), (256, 512)]),
    (608, "float16", [(0, 208), (208, 416), (416, 608)]),
    (512, "float32", [(0, 256), (256, 512)]),
    (300, "float32", [(0, 152), (152, 300)]),
    (258, "float32", [(0, 129), (129, 258)])])
def test_ssd_split_n(n, dtype, parts):
    assert ssd_kernel.split_n(n, getattr(torch, dtype)) == parts


# (b, s, h, p, n, chunk, P tile): bf16 rows of the plans every shape the
# kernel ran at keeps (test_torch_kernel_shapes.py's SSD_KEPT): float16
# plans alike
SSD_BF16_KEPT = [(1, 128, 4, 32, 16, 32, 16), (4, 512, 32, 64, 128, 128, 64),
                 (1, 128, 32, 64, 128, 128, 32),
                 (1, 128, 136, 128, 32, 64, 128),
                 (4, 512, 128, 128, 128, 128, 64),
                 (8, 128, 16, 32, 16, 32, 32)]


@pytest.mark.parametrize("b,s,h,p,n,chunk,tile", SSD_BF16_KEPT)
def test_ssd_float16_plans_as_bf16(b, s, h, p, n, chunk, tile):
    args = (b, s, h, p, n, chunk)
    bf16 = ssd_kernel.plan(*args, torch.bfloat16, H100_SMEM, H100_SMS)
    assert ssd_kernel.plan(*args, torch.float16, H100_SMEM, H100_SMS) == bf16
    assert (bf16.p, bf16.n, bf16.chunk, bf16.p_tile) == (p, n, chunk, tile)
    assert ssd_kernel.plans(*args, torch.float16, H100_SMEM, H100_SMS) \
        == [(0, n, bf16)]


# -- the ops reach the library at the new shapes, never the plain version ----


class FakeCuda(torch.Tensor):
    """A CPU tensor that says it lies on a CUDA device: drives the ops'
    card path to the (stubbed) library without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake(*shape, dtype=torch.float32):
    return torch.zeros(*shape, dtype=dtype).as_subclass(FakeCuda)


class FakeLib:
    """Records each entry point's arguments and returns success, and which
    library (``library(f16)``) each launch asked for."""

    def __init__(self):
        self.calls = []
        self.f16 = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def card(monkeypatch):
    """The stubbed library of every kernel, a stream, and ``torch.empty``
    on the stand-in device."""
    lib = FakeLib()
    for mod in (fa_kernel, ssd_kernel, km_kernel):
        monkeypatch.setattr(mod, "library", lambda *f16: (
            lib.f16.append(bool(f16 and f16[0])), lib)[1])
        monkeypatch.setattr(mod, "max_smem", lambda index: H100_SMEM)
    monkeypatch.setattr(ssd_kernel, "sm_count", lambda index: H100_SMS)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch, "empty", lambda *s, **k: _fake(
        *s, dtype=k.get("dtype", torch.float32)))
    for mod, name in ((fa_ops, "attention_ref"), (ssd_ops, "ssd_reference"),
                      (km_ops, "assign_ref")):
        monkeypatch.setattr(mod, name, lambda *a, **k: pytest.fail(
            "a plain version ran for a CUDA tensor"))
    return lib


@pytest.mark.parametrize("d,dtype", [(320, torch.float16),
                                     (512, torch.bfloat16),
                                     (300, torch.float32),
                                     (128, torch.float16)])
def test_flash_op_launches_the_instance_of_its_plan(card, d, dtype):
    before = fa_ops.launches
    out = fa_ops.flash_attention(_fake(1, 64, 4, d, dtype=dtype),
                                 _fake(1, 64, 2, d, dtype=dtype),
                                 _fake(1, 64, 2, d, dtype=dtype), window=16)
    assert fa_ops.launches == before + 1 and out.shape == (1, 64, 4, d)
    (name, args), = card.calls
    assert name == "flash_attention_launch"
    assert card.f16 == [dtype == torch.float16]
    head_dim, scale, code = args[8], args[11], args[12]
    assert head_dim == fa_kernel.padded_head_dim(d)
    assert code == fa_kernel._DTYPE_CODE[dtype]
    assert scale == pytest.approx(1 / math.sqrt(d))


# (p, n, dtype, each launch's (N, y mode, has the f32 sum))
SSD_LAUNCHES = [
    (64, 128, torch.float16, [(128, 0, False)]),
    (40, 320, torch.float16, [(160, 1, True), (160, 3, True)]),
    (64, 512, torch.bfloat16, [(256, 1, True), (256, 3, True)]),
    (32, 600, torch.bfloat16, [(208, 1, True), (208, 2, True),
                               (192, 3, True)]),
    (32, 512, torch.float32, [(256, 0, False), (256, 2, False)])]


@pytest.mark.parametrize("p,n,dtype,launches", SSD_LAUNCHES)
def test_ssd_op_launches_each_part_of_its_plan(card, p, n, dtype, launches):
    before = ssd_ops.launches
    y, state = ssd_ops.ssd(_fake(1, 256, 2, p, dtype=dtype), _fake(1, 256, 2),
                           _fake(1, 256, n, dtype=dtype),
                           _fake(1, 256, n, dtype=dtype), 128)
    assert ssd_ops.launches == before + 1
    assert y.shape == (1, 256, 2, p) and state.shape == (1, 2, p, n)
    assert [name for name, _ in card.calls] == ["ssd_scan_launch"] \
        * len(launches)
    got = [(args[8], args[16], args[15] is not None)
           for _, args in card.calls]
    assert got == launches
    assert all(args[10] == ssd_kernel._DTYPE_CODE[dtype]
               for _, args in card.calls)
    assert card.f16 == [dtype == torch.float16] * len(launches)


@pytest.mark.parametrize("d,k,dtype,entry", [
    (64, 3, torch.float32, "kmeans_assign_launch"),
    (64, 3, torch.float16, "kmeans_assign_launch"),
    (300, 3, torch.float32, "kmeans_assign_block_launch"),
    (4097, 5, torch.float32, "kmeans_assign_block_launch"),
    (8192, 3, torch.bfloat16, "kmeans_assign_block_launch"),
    (128, 1024, torch.float16, "kmeans_assign_block_launch")])
def test_kmeans_op_launches_the_instance_of_its_plan(card, d, k, dtype,
                                                     entry):
    before = km_ops.launches
    a, d2 = km_ops.assign_with_dist(_fake(64, d, dtype=dtype),
                                    _fake(k, d, dtype=dtype))
    assert km_ops.launches == before + 1 and a.shape == (64,)
    (name, args), = card.calls
    assert name == entry and args[4:6] == (d, k)
    assert args[6] == km_kernel._DTYPE_CODE[dtype]


# -- float16 models against the reference's -----------------------------------


def _port_params(cfg):
    """The port's parameters for ``cfg`` from a seeded generator, and the
    same values as the reference's tree (no JAX init to compile)."""
    tp = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    return tp, jax.tree.map(jnp.asarray, tree_to_numpy(tp))


def test_float16_lm_matches_the_reference():
    """A 2-layer qwen3 smoke LM at float16, the port's kernel path (its
    CPU path) against the reference's Pallas path in interpret mode, at
    the bf16 runs' bound (``test_torch_attention.BF16_TOL``)."""
    rc = dataclasses.replace(jax_config.get_smoke_config("qwen3-1.7b").model,
                             n_layers=2, dtype="float16")
    tc = dataclasses.replace(port_config.get_smoke_config("qwen3-1.7b").model,
                             n_layers=2, dtype="float16")
    tp, rp = _port_params(tc)
    toks = np.random.default_rng(1).integers(0, rc.vocab_size,
                                             (2, 24)).astype(np.int32)
    want, _ = jax_build(rc, attn_impl="pallas").forward(rp,
                                                        jnp.asarray(toks))
    got, _ = LM(tc, attn_impl="kernel", device="cpu").forward(
        tp, torch.from_numpy(toks))
    assert got.dtype == torch.float16
    _close(got, want, 2e-2)


def test_float16_mamba_mixer_matches_the_reference():
    """mamba2-370m's smoke mixer at float16 through the SSD op (its CPU
    path) against the reference's Pallas path in interpret mode, at the
    bf16 runs' bound (``test_torch_mamba2.BF16_TOL``)."""
    rc = dataclasses.replace(
        jax_config.get_smoke_config("mamba2-370m").model, dtype="float16")
    tc = dataclasses.replace(
        port_config.get_smoke_config("mamba2-370m").model, dtype="float16")
    tp, rp = _port_params(tc)
    h = np.random.default_rng(2).standard_normal(
        (1, 32, rc.d_model)).astype(np.float32)
    p_ref = jax.tree.map(lambda a: a[0], rp["groups"]["sub0"]["mix"])
    p_port = tree_map(lambda a: a[0], tp["groups"]["sub0"]["mix"])
    y_ref, c_ref = jax_m.mamba_mixer_with_state(
        p_ref, rc, jnp.asarray(h, jnp.float16), use_kernel=True)
    y, c = port_m.mamba_mixer_with_state(
        p_port, tc, torch.from_numpy(h).to(torch.float16), use_kernel=True)
    assert y.dtype == torch.float16
    _close(y, y_ref, 6e-2)
    for key in c_ref:
        _close(c[key], c_ref[key], 6e-2)

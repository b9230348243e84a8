"""Mamba training in the port vs the reference, on the CPU.

The SSD op's gradient (``repro_torch.kernels.ssd_scan.ops.ssd``, an
``autograd.Function`` whose backward re-runs the plain ``ssd_reference``)
against ``jax.vjp`` of the reference's ``custom_vjp`` op with its Pallas
forward in interpret mode, cotangents on both outputs (y and the final
state), at the f32 shapes of ``tests/test_kernels.py``: each gradient
within 1e-4 of its largest magnitude.  (The gradients reach a few
hundred, and dda's entries are sums of such terms that cancel: either
side lies up to ~3e-6 of the largest magnitude from the f64 value, so an
entry near zero can miss a 1e-4 absolute bound on f32 rounding alone.)
Then mamba2-370m's smoke ``LM.loss`` and its gradient tree against the
reference's (loss 1e-5, gradients 1e-4), through the plain SSD and
through the op (with remat, so the op's forward runs again in the
recompute), and ``launch.train`` on the CPU.  Inputs are drawn with
numpy; the LM's weights are the reference's init carried across.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import config as jax_config  # noqa: E402
from repro.kernels.ssd_scan.ops import ssd as jax_ssd  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch import config as port_config  # noqa: E402
from repro_torch.interop import tree_from_numpy, tree_leaves, \
    tree_to_numpy  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.train.state import loss_and_grads  # noqa: E402

LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small ops on a CPU that other test processes load: torch's OpenMP
    pool spin-waits between them (this module's launcher tests took 10-18
    s each under the suite's 6 workers, 0.1 s alone).  One intra-op
    thread for this module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# (b, s, h, p, n, chunk): the f32 cases of tests/test_kernels.py
SSD_CASES = [(2, 128, 4, 32, 16, 32), (1, 256, 2, 64, 128, 128),
             (1, 64, 8, 64, 64, 32), (2, 128, 2, 128, 128, 64)]


def _ssd_inputs(b, s, h, p, n, seed):
    """x * softplus(dt), da = dt * A, B, C (the reference test's recipe,
    drawn with numpy), and cotangents for y and the final state."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    x = (rng.standard_normal((b, s, h, p)) * dt[..., None]).astype(
        np.float32)
    a = -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32)
    bm, cm = (rng.standard_normal((b, s, n)).astype(np.float32)
              for _ in range(2))
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dstate = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return [x, (dt * a).astype(np.float32), bm, cm], (dy, dstate)


def _close_scaled(got, want, tol):
    """Every entry within ``tol`` of the tensor's largest magnitude."""
    want = np.asarray(want, np.float32)
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_CASES)
def test_ssd_gradient_matches_reference_custom_vjp(b, s, h, p, n, chunk):
    inputs, (dy, dstate) = _ssd_inputs(b, s, h, p, n, seed=s * h + p)

    @jax.jit
    def ref(*a):
        out, vjp = jax.vjp(lambda *z: jax_ssd(*z, chunk, True), *a)
        return out, vjp((jnp.asarray(dy), jnp.asarray(dstate)))
    (y_ref, st_ref), want = ref(*map(jnp.asarray, inputs))
    tensors = [t.requires_grad_() for t in tree_from_numpy(inputs, "cpu")]
    before = ops.launches
    y, state = ops.ssd(*tensors, chunk)
    got = torch.autograd.grad((y, state), tensors,
                              (torch.from_numpy(dy), torch.from_numpy(dstate)))
    assert ops.launches == before            # the CPU path launches nothing
    _close_scaled(y, y_ref, GRAD_TOL)
    _close_scaled(state, st_ref, GRAD_TOL)
    for g, w in zip(got, want):              # dx, dda, dB, dC
        _close_scaled(g, w, GRAD_TOL)


def test_ssd_gradient_of_one_output_alone():
    """Training reads y only: the final state's cotangent is zero."""
    inputs, (dy, _) = _ssd_inputs(1, 64, 2, 32, 16, seed=1)
    want = jax.jit(lambda *a: jax.vjp(
        lambda *z: jax_ssd(*z, 32, True)[0], *a)[1](jnp.asarray(dy)))(
        *map(jnp.asarray, inputs))
    tensors = [t.requires_grad_() for t in tree_from_numpy(inputs, "cpu")]
    y, _ = ops.ssd(*tensors, 32)
    got = torch.autograd.grad(y, tensors, torch.from_numpy(dy))
    for g, w in zip(got, want):
        _close_scaled(g, w, GRAD_TOL)


@pytest.fixture(scope="module")
def mamba():
    """(ref cfg, port cfg, ref params, port params, batch): the smoke
    config at f32, the reference's init with its zero-initialised norm
    scales drawn non-zero, and a masked batch."""
    kw = {"dtype": "float32"}
    rc = dataclasses.replace(
        jax_config.get_smoke_config("mamba2-370m").model, **kw)
    tc = dataclasses.replace(
        port_config.get_smoke_config("mamba2-370m").model, **kw)
    rp = jax.jit(jax_build(rc).init)(jax.random.key(0))
    rng = np.random.default_rng(1)
    rp = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.1 * rng.standard_normal(a.shape)).astype(
            np.float32) if "norm" in getattr(path[-1], "key", "")
        else np.asarray(a), rp)
    toks = rng.integers(0, rc.vocab_size, (2, 64)).astype(np.int32)
    mask = (np.arange(63)[None, :] % 7 != 0).astype(np.float32) \
        * np.ones((2, 1), np.float32)
    return rc, tc, rp, tree_from_numpy(rp, "cpu"), \
        {"tokens": toks, "loss_mask": mask}


@pytest.mark.parametrize("use_kernel,remat", [(False, False), (True, True)],
                         ids=["plain", "op-remat"])
def test_loss_and_gradients_match_reference(mamba, use_kernel, remat,
                                            monkeypatch):
    """``LM.loss`` and the gradient to every leaf; with ``use_kernel`` the
    SSD goes through the op on both sides (the reference's Pallas forward
    in interpret mode), once a layer in the forward and once more in each
    remat recompute."""
    rc, tc, rp, tp, batch = mamba
    rc, tc = (dataclasses.replace(c, remat=remat) for c in (rc, tc))
    rm = jax_build(rc, use_ssd_kernel=use_kernel)
    (_, m_ref), g_ref = jax.jit(jax.value_and_grad(rm.loss, has_aux=True))(
        jax.tree.map(jnp.asarray, rp), jax.tree.map(jnp.asarray, batch))
    calls = []
    forward = ops._forward
    monkeypatch.setattr(ops, "_forward",
                        lambda *a: calls.append(1) or forward(*a))
    tm = LM(tc, use_ssd_kernel=use_kernel, device="cpu")
    metrics, grads = loss_and_grads(
        tm, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert len(calls) == (2 * tc.n_layers if use_kernel else 0)
    for key in ("loss", "ce_loss"):
        np.testing.assert_allclose(float(metrics[key]), float(m_ref[key]),
                                   atol=LOSS_TOL, rtol=LOSS_TOL)
    got, want = tree_leaves(tree_to_numpy(grads)), jax.tree.leaves(g_ref)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=GRAD_TOL,
                                   rtol=GRAD_TOL)


def test_train_launcher_trains_mamba_on_cpu(capsys):
    out = port_train.main(["--arch", "mamba2-370m", "--smoke", "--device",
                           "cpu", "--steps", "2", "--log-every", "1"])
    assert len(out["metrics"]) == 2
    assert all(np.isfinite(m["loss"]) for m in out["metrics"])
    assert "loss=" in capsys.readouterr().out

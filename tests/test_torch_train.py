"""The port's optimizer, train step, ``LMExecutor`` and trainer on the CPU
vs the reference's.

The optimizer maths (schedules, clipping, AdamW and SGD with f32 and bf16
moments) is held to 1e-6 on the same numpy gradients.  qwen3-1.7b's smoke
config at f32 trains from the reference's initial parameters on the
reference's token stream (``jax_batches``: the port's own stream draws
from numpy, the reference's from ``jax.random``, so the tests hand the
reference's batches to the port): three SGD steps give the same
parameters to 1e-5, three AdamW steps the same losses to 1e-4, an
``LMExecutor`` block (AdamW) the same parameters to ``ADAM_PARAM_TOL``,
and a short sync EL run the same ``(interval, edge)`` decisions.  Last, ``launch.train.main`` runs on the CPU in both modes.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import config as jax_config  # noqa: E402
from repro.data import SyntheticLMData as JaxLMData  # noqa: E402
from repro.el import ELSession as JaxSession  # noqa: E402
from repro.federated import LMExecutor as JaxLMExecutor  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro.train import state as jax_state  # noqa: E402
from repro_torch import config as port_config  # noqa: E402
from repro_torch.el import ELSession  # noqa: E402
from repro_torch.federated import LMExecutor  # noqa: E402
from repro_torch.interop import tree_from_numpy, tree_leaves, \
    tree_to_numpy  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.train import optimizer as port_opt  # noqa: E402
from repro_torch.train import state as port_state  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module, restored after: its runs are
    many small ops, and beside the other test workers torch's OpenMP pool
    spin-waits between them (the same loaded test ran 4x faster so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


OPT_TOL = 1e-6
# AdamW normalises each element's step to about lr (the smoke config's
# peak_lr, 3e-4): an element whose gradient lies near zero, where the f32
# summation order alone moves it, can take a step of another size or
# sign.  Parameters trained by AdamW are held to one step's lr (absolute)
# and 1e-5 relative; the SGD test holds the gradients themselves to 1e-5.
ADAM_PARAM_TOL = 3e-4


def _tc(**kw):
    return jax_config.TrainConfig(**kw), port_config.TrainConfig(**kw)


def _np_leaves(tree):
    if isinstance(jax.tree.leaves(tree)[0], jax.Array):
        return [np.asarray(a, np.float32) for a in jax.tree.leaves(tree)]
    return [a.astype(np.float32) for a in jax.tree.leaves(
        tree_to_numpy(tree))]


def _assert_leaves_close(got, want, tol):
    g, w = _np_leaves(got), _np_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


# -- optimizer maths ------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
def test_lr_schedule_matches_reference(schedule):
    jc, tc = _tc(schedule=schedule, warmup_steps=17, total_steps=200,
                 peak_lr=3e-4, min_lr_ratio=0.1, decay_start_frac=0.8)
    for step in [0, 1, 16, 17, 18, 100, 159, 160, 161, 199, 200, 450]:
        np.testing.assert_allclose(float(port_opt.lr_schedule(tc, step)),
                                   float(jax_opt.lr_schedule(jc, step)),
                                   rtol=OPT_TOL)
    assert float(port_opt.lr_schedule(tc, torch.tensor(5, dtype=torch.int32))
                 ) == float(port_opt.lr_schedule(tc, 5))


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (scale * rng.standard_normal((6, 5))).astype(np.float32),
            "blk": {"b": (scale * rng.standard_normal(5)).astype(np.float32),
                    "a": (scale * rng.standard_normal((2, 3))).astype(
                        np.float32)}}


@pytest.mark.parametrize("max_norm", [0.0, 1.0, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(1, scale=3.0)
    want, want_norm = jax_opt.clip_by_global_norm(
        jax.tree.map(jnp.asarray, g), max_norm)
    got, norm = port_opt.clip_by_global_norm(tree_from_numpy(g, "cpu"),
                                             max_norm)
    np.testing.assert_allclose(float(norm), float(want_norm), rtol=OPT_TOL)
    _assert_leaves_close(got, want, OPT_TOL)


@pytest.mark.parametrize("mdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt,momentum", [("adamw", 0.9), ("sgd", 0.9),
                                          ("sgd", 0.0)])
def test_apply_updates_matches_reference(opt, momentum, mdt):
    """Three steps on the same numpy gradients (the last one clipped)."""
    jc, tc = _tc(optimizer=opt, momentum=momentum, opt_state_dtype=mdt,
                 peak_lr=0.05, warmup_steps=2, total_steps=10,
                 weight_decay=0.1, grad_clip=1.0)
    p0 = _tree(2)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = tree_from_numpy(p0, "cpu")
    jo, to = jax_opt.init_opt_state(jc, jp), port_opt.init_opt_state(tc, tp)
    _assert_leaves_close(to, jo, 0.0)
    for i, scale in enumerate((0.1, 0.05, 2.0)):
        g = _tree(10 + i, scale)
        jp, jo, jm = jax_opt.apply_updates(jc, jp, jax.tree.map(
            jnp.asarray, g), jo)
        tp, to, tm = port_opt.apply_updates(tc, tp, tree_from_numpy(
            g, "cpu"), to)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=OPT_TOL)
        _assert_leaves_close(tp, jp, OPT_TOL)
        _assert_leaves_close(to.mu, jo.mu, OPT_TOL)
        _assert_leaves_close(to.nu, jo.nu, OPT_TOL)
        assert int(to.step) == int(jo.step)
        assert [str(t.dtype) for t in tree_leaves(to.mu)] == [
            "torch." + str(a.dtype) for a in jax.tree.leaves(jo.mu)]


def test_opt_state_carries_across_through_interop():
    jc, tc = _tc(opt_state_dtype="bfloat16")
    jo = jax_opt.init_opt_state(jc, jax.tree.map(jnp.asarray, _tree(3)))
    # the reference's NamedTuple re-labelled as the port's, leaves as numpy
    to = tree_from_numpy(port_opt.OptState(*jax.tree.map(np.asarray, jo)),
                         "cpu")
    assert isinstance(to, port_opt.OptState)
    assert to.step.dtype == torch.int32 and to.step.dim() == 0
    assert to.mu["w"].dtype == torch.bfloat16
    back = tree_to_numpy(to)
    for g, w in zip(jax.tree.leaves(tuple(back)),
                    jax.tree.leaves(tuple(jo))):
        np.testing.assert_array_equal(np.asarray(g, np.float32),
                                      np.asarray(w, np.float32))


# -- qwen3 smoke training ---------------------------------------------------------


class jax_batches:
    """The reference's token stream as the port's ``SyntheticLMData``
    interface: ``batch(edge, step, device)``."""

    def __init__(self, data: JaxLMData):
        self.data = data

    def batch(self, edge, step, device=None):
        toks = np.array(self.data.batch(edge, step)["tokens"])
        return {"tokens": torch.from_numpy(toks).to(device or "cpu")}


def _f32(exp):
    return dataclasses.replace(exp, model=dataclasses.replace(
        exp.model, dtype="float32"))


@pytest.fixture(scope="module")
def qwen():
    """The smoke config at f32 (its own dtype is bf16, where XLA and torch
    round at other places), in both packages, and the reference's model
    and initial parameters."""
    exp = _f32(port_config.get_smoke_config("qwen3-1.7b"))
    rexp = _f32(jax_config.get_smoke_config("qwen3-1.7b"))
    rm = jax_build(rexp.model)
    rp = rm.init(jax.random.key(0))
    return rexp, exp, rm, rp


def _run_steps(rexp, exp, rm, rp, train_cfg_kw, n):
    jc = dataclasses.replace(rexp.train, **train_cfg_kw)
    tc = dataclasses.replace(exp.train, **train_cfg_kw)
    data = JaxLMData.for_model(rexp.model, 2, 32)
    jstep = jax.jit(jax_state.make_train_step(rm, jc))
    tm = LM(exp.model, device="cpu")
    tstep = port_state.make_train_step(tm, tc)
    js = jax_state.TrainState(rp, jax_opt.init_opt_state(jc, rp))
    tparams = tree_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    ts = port_state.TrainState(tparams, port_opt.init_opt_state(tc,
                                                                 tparams))
    losses = []
    for i in range(n):
        b = data.batch(0, i)
        js, jm = jstep(js, b)
        ts, tmet = tstep(ts, {"tokens": torch.from_numpy(np.array(
            b["tokens"]))})
        losses.append((float(tmet["loss"]), float(jm["loss"])))
        for k in ("ce_loss", "lr", "grad_norm"):
            assert math.isfinite(float(tmet[k]))
    return js, ts, losses


def test_three_sgd_steps_give_the_reference_params(qwen):
    js, ts, losses = _run_steps(*qwen, dict(optimizer="sgd", peak_lr=0.05),
                                3)
    _assert_leaves_close(ts.params, js.params, 1e-5)
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_three_adamw_steps_give_the_reference_losses(qwen):
    _, _, losses = _run_steps(*qwen, {}, 3)
    assert losses[-1][1] < losses[0][1]
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _executors(rexp, exp, rm, batch=2, seq=32):
    jex = JaxLMExecutor(rm, rexp.model, rexp.train, batch=batch,
                        seq_len=seq, seed=0)
    tex = LMExecutor(LM(exp.model, device="cpu"), exp.model, exp.train,
                     batch=batch, seq_len=seq, seed=0)
    tex.data = jax_batches(jex.data)
    tex._eval_batch = tex.data.batch(999, 0)
    return jex, tex


def test_lm_executor_local_train_matches_reference(qwen):
    rexp, exp, rm, rp = qwen
    jex, tex = _executors(rexp, exp, rm)
    tp = tree_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    before = [t.clone() for t in tree_leaves(tp)]
    for edge, n in ((1, 3), (1, 2), (0, 1)):   # the step counter advances
        jp, _ = jex.local_train(rp, edge, n, seed=0)
        got, info = tex.local_train(tp, edge, n, seed=0)
        assert info == {}
        for a, b in zip(_np_leaves(got), _np_leaves(jp)):
            np.testing.assert_allclose(a, b, atol=ADAM_PARAM_TOL, rtol=1e-5)
    # the caller's parameters are left as they were
    for a, b in zip(tree_leaves(tp), before):
        assert torch.equal(a, b)
    assert list(tex._step_counter[:2]) == list(jex._step_counter[:2])
    want = jex.evaluate(rp)
    got = tex.evaluate(tp)
    assert set(got) == {"loss", "neg_loss"}
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert got["neg_loss"] == -got["loss"]


def test_sync_run_over_the_lm_makes_the_reference_decisions(qwen):
    rexp, exp, rm, rp = qwen
    jex, tex = _executors(rexp, exp, rm)
    kw = dict(n_edges=2, heterogeneity=2.0, budget=1500.0, mode="sync",
              utility="loss_delta")
    jcfg = dataclasses.replace(rexp.ol4el, **kw)
    tcfg = dataclasses.replace(exp.ol4el, **kw)
    want = (JaxSession(jcfg, metric_name="loss", lr=rexp.train.peak_lr)
            .with_executor(jex, init_params=rp).run_sync(max_rounds=6))
    got = (ELSession(tcfg, metric_name="loss", lr=exp.train.peak_lr)
           .with_executor(tex, init_params=tree_from_numpy(
               jax.tree.map(np.asarray, rp), "cpu")).run_sync(max_rounds=6))
    assert [(r.interval, r.edge) for r in got.records] == \
        [(r.interval, r.edge) for r in want.records]
    assert got.terminated_reason == want.terminated_reason
    assert got.total_consumed == want.total_consumed
    assert got.n_aggregations >= 3
    np.testing.assert_allclose([r.metric for r in got.records],
                               [r.metric for r in want.records], rtol=1e-4)
    for a, b in zip(_np_leaves(got.final_params),
                    _np_leaves(want.final_params)):
        np.testing.assert_allclose(a, b, atol=ADAM_PARAM_TOL, rtol=1e-5)


@pytest.mark.parametrize("mode", ["standard", "ol4el"])
def test_train_launcher_runs_on_cpu(mode, capsys):
    argv = ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
            "--mode", mode, "--steps", "2", "--log-every", "1"]
    if mode == "ol4el":
        argv += ["--el-mode", "sync", "--edges", "2", "--budget", "2000"]
    out = port_train.main(argv)
    if mode == "standard":
        assert len(out["metrics"]) == 2 and len(out["step_s"]) == 2
        assert all(math.isfinite(m["loss"]) for m in out["metrics"])
        assert int(out["state"].opt.step) == 2
    else:
        assert out.n_aggregations == 2
        assert math.isfinite(out.final_metric)
        assert out.terminated_reason == "max_rounds"
    assert "loss=" in capsys.readouterr().out


def test_train_launcher_defaults_and_classic_archs(capsys):
    """Classic archs under ``--mode ol4el`` run the compiled programs:
    ``--el-mode sync`` the sync round (``run_sync_ingraph``), the default
    ``--el-mode async`` the async event engine (``run_async_ingraph``)."""
    exp = port_config.get_config("qwen3-1.7b")
    args = port_train.parse_args(["--arch", "qwen3-1.7b"])
    assert args.batch is None and args.seq is None
    assert (exp.train.global_batch, exp.train.seq_len) == (8, 512)
    rep = port_train.main(["--arch", "svm-wafer", "--mode", "ol4el",
                           "--el-mode", "sync", "--device", "cpu",
                           "--samples", "600", "--edges", "2",
                           "--budget", "1200", "--steps", "16"])
    assert rep.mode == "sync" and rep.n_aggregations > 0
    assert rep.terminated_reason == "budget_exhausted"
    assert 0.5 < rep.final_metric <= 1.0
    assert rep.telemetry["device_loop"]["chunks"] == 1
    assert "compiled sync run" in capsys.readouterr().out
    rep = port_train.main(["--arch", "svm-wafer", "--mode", "ol4el",
                           "--device", "cpu", "--samples", "600",
                           "--edges", "2", "--budget", "1200",
                           "--async-batch-k", "2"])
    assert rep.mode == "async" and rep.n_aggregations > 0
    assert rep.terminated_reason == "budget_exhausted"
    assert {r.edge for r in rep.records} == {0, 1}
    assert rep.telemetry["device_loop"]["batch_k"] == 2
    assert "compiled async run" in capsys.readouterr().out

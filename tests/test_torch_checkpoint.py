"""The port's checkpointing (``repro_torch.train.checkpoint``) vs the
reference's ``repro.train.checkpoint``, on the CPU.

The files are the reference's ``.npz`` format, so the test crosses
packages on real ``TrainState``s (a 4-layer deepseek-moe smoke model:
its dense first layer is a ``prefix_layers`` list entry; AdamW moments
in bfloat16): a port round trip is bit for bit, dtypes kept; a
reference ``save`` restores in the port and a port ``save`` in the
reference, with the same key set and equal values; ``latest_step``; the
shape-mismatch and missing-leaf errors; ``launch.train.main(--ckpt)`` for
the standard, the LM ol4el and the classic ol4el entry points.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import config as jax_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.train import checkpoint as jax_ckpt  # noqa: E402
from repro.train import init_train_state as jax_init_state  # noqa: E402
from repro_torch import config as port_config  # noqa: E402
from repro_torch.interop import tree_leaves, tree_map, \
    tree_to_numpy  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import init_train_state  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    """deepseek-moe-16b's smoke model at 4 layers (a dense prefix layer,
    then MoE groups) and a TrainConfig with bf16 moments, both
    packages."""
    def make(pkg):
        exp = pkg.get_smoke_config("deepseek-moe-16b")
        return (dataclasses.replace(exp.model, n_layers=4, dtype="float32"),
                dataclasses.replace(exp.train, opt_state_dtype="bfloat16"))
    return make(jax_config), make(port_config)


@functools.lru_cache(maxsize=None)
def _states():
    """(reference TrainState, port TrainState), each its package's own
    init, with non-zero moments so the bf16 leaves carry values."""
    (rc, rt), (tc, tt) = _cfgs()
    ref = jax_init_state(jax_build(rc), rt, jax.random.key(0))
    ref = ref._replace(opt=ref.opt._replace(
        mu=jax.tree.map(lambda p: (0.5 * p).astype(jax.numpy.bfloat16),
                        ref.params),
        step=ref.opt.step + 3))
    port = init_train_state(LM(tc, device="cpu"), tt,
                            torch.Generator().manual_seed(0))
    for m, p in zip(tree_leaves(port.opt.mu), tree_leaves(port.params)):
        m.copy_(0.25 * p)
    port.opt.step.fill_(5)
    return ref, port


def _zeros_like(state):
    return tree_map(torch.zeros_like, state)


def _np(tree):
    return [np.asarray(a, np.float32) for a in tree_leaves(
        tree_to_numpy(tree))]


def test_port_round_trip_is_bit_for_bit(tmp_path):
    _, state = _states()
    assert "prefix_layers" in state.params
    assert tree_leaves(state.opt.mu)[0].dtype == torch.bfloat16
    ckpt.save(str(tmp_path / "s"), state, step=7)
    got = ckpt.restore(str(tmp_path / "s"), _zeros_like(state))
    assert type(got) is type(state) and type(got.opt) is type(state.opt)
    assert isinstance(got.params["prefix_layers"], list)
    for g, w in zip(tree_leaves(got), tree_leaves(state)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    keys = set(np.load(tmp_path / "s.npz").files)
    assert "opt/step" in keys and "_ckpt_step" in keys
    assert "params/prefix_layers/0/mix/wq" in keys
    assert any(k.startswith("bf16:opt/mu/") for k in keys)
    assert not any(k.startswith("bf16:params/") for k in keys)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    ref, port = _states()
    jax_ckpt.save(str(tmp_path / "r"), ref, step=3)
    got = ckpt.restore(str(tmp_path / "r"), _zeros_like(port))
    want = [np.asarray(a, np.float32) for a in jax.tree.leaves(ref)]
    assert len(_np(got)) == len(want)
    assert np.abs(np.asarray(jax.tree.leaves(ref.opt.mu)[0],
                             np.float32)).max() > 0
    for g, w in zip(_np(got), want):
        np.testing.assert_array_equal(g, w)
    assert tree_leaves(got.opt.mu)[0].dtype == torch.bfloat16
    assert ckpt.latest_step(str(tmp_path / "r")) == 3


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    ref, port = _states()
    ckpt.save(str(tmp_path / "p.npz"), port, step=11)
    jax_ckpt.save(str(tmp_path / "r.npz"), ref, step=11)
    # the same key strings, from the two packages' own trees
    assert set(np.load(tmp_path / "p.npz").files) == \
        set(np.load(tmp_path / "r.npz").files)
    got = jax_ckpt.restore(str(tmp_path / "p.npz"), ref)
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for g, w in zip(jax.tree.leaves(got), _np(port)):
        np.testing.assert_array_equal(np.asarray(g, np.float32), w)
    assert jax.tree.leaves(got.opt.mu)[0].dtype == jax.numpy.bfloat16
    assert jax_ckpt.latest_step(str(tmp_path / "p")) == 11


def test_latest_step_and_bare_leaves(tmp_path):
    assert ckpt.latest_step(str(tmp_path / "missing")) is None
    leaf = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    ckpt.save(str(tmp_path / "a"), leaf)
    assert ckpt.latest_step(str(tmp_path / "a")) is None
    assert np.load(tmp_path / "a.npz").files == ["_root"]
    assert torch.equal(ckpt.restore(str(tmp_path / "a.npz"),
                                    torch.zeros(2, 3)), leaf)
    # a bare bf16 leaf, and a float32 file into a float64 template
    ckpt.save(str(tmp_path / "b"), leaf.bfloat16(), step=2)
    assert np.load(tmp_path / "b.npz").files == ["bf16:_root",
                                                 "_ckpt_step"]
    back = ckpt.restore(str(tmp_path / "b"), torch.zeros(2, 3,
                                                         dtype=torch.float64))
    assert back.dtype == torch.float64 and torch.equal(back, leaf.double())
    assert ckpt.latest_step(str(tmp_path / "b")) == 2
    assert jax_ckpt.latest_step(str(tmp_path / "b")) == 2


def test_shape_mismatch_and_missing_leaf_raise(tmp_path):
    tree = {"w": torch.ones(2, 3), "b": [torch.zeros(3)]}
    ckpt.save(str(tmp_path / "t"), tree)
    with pytest.raises(ValueError, match="shape mismatch for 'w'"):
        ckpt.restore(str(tmp_path / "t"), {"w": torch.ones(3, 2),
                                           "b": [torch.zeros(3)]})
    with pytest.raises(KeyError, match="missing leaf 'b/1'"):
        ckpt.restore(str(tmp_path / "t"), {"w": torch.ones(2, 3),
                                           "b": [torch.zeros(3),
                                                 torch.zeros(1)]})


@pytest.mark.parametrize("mode", ["standard", "ol4el", "classic"])
def test_train_launcher_saves_its_result(mode, tmp_path, capsys):
    """``--ckpt``: the standard loop's ``TrainState`` at step ``n_steps``,
    an ol4el run's final parameters at its aggregation count (the LM
    host loop, and a classic arch's compiled sync round)."""
    path = str(tmp_path / "run.npz")
    if mode == "classic":
        argv = ["--arch", "svm-wafer", "--mode", "ol4el", "--el-mode", "sync",
                "--samples", "600", "--edges", "2", "--budget", "1200",
                "--steps", "16"]
    else:
        argv = ["--arch", "qwen3-1.7b", "--smoke", "--mode", mode,
                "--steps", "2"]
        if mode == "ol4el":
            argv += ["--el-mode", "sync", "--edges", "2", "--budget", "2000"]
    out = port_train.main(argv + ["--device", "cpu", "--ckpt", path])
    assert "saved" in capsys.readouterr().out
    if mode == "standard":
        tree, step = out["state"], 2
    else:
        tree, step = out.final_params, out.n_aggregations
    assert ckpt.latest_step(path) == step
    got = ckpt.restore(path, _zeros_like(tree))
    for g, w in zip(tree_leaves(got), tree_leaves(tree)):
        assert torch.equal(g, w)

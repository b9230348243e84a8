"""The port stands alone: no module of ``src/repro_torch`` (nor
``chip_smoke.py``) imports JAX, the JAX package or its ``benchmarks``
harness, and the entry points default to CUDA and refuse to fall back to
the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_every_port_module_imports_without_jax_or_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'repro', 'benchmarks')]\n"
        "assert len(names) > 20, names\n"
        "assert 'repro_torch.bench.run' in names, names\n"
        "assert {'repro_torch.obs.rings', 'repro_torch.obs.prof',\n"
        "        'repro_torch.obs.regress'} <= set(names), names\n"
        "assert {'repro_torch.examples.quickstart',\n"
        "        'repro_torch.examples.serve_batched',\n"
        "        'repro_torch.examples.train_lm_ol4el',\n"
        "        'repro_torch.launch.dryrun', 'repro_torch.launch.specs',\n"
        "        'repro_torch.bench.roofline'} <= set(names), names\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            root = m.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro", "benchmarks"), \
                (path, m)


def test_resolve_device_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from repro_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_default_to_cuda(monkeypatch):
    from repro_torch.config import get_smoke_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.interop import params_from_numpy, tree_from_numpy
    from repro_torch.launch import serve, train
    from repro_torch.launch.classic import classic_fixture
    from repro_torch.models import LM, build_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        classic_fixture("svm-wafer", samples=200, n_edges=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({})
    with pytest.raises(RuntimeError, match="CUDA"):
        tree_from_numpy({"groups": [{}]})
    cfg = get_smoke_config("mamba2-370m").model
    with pytest.raises(RuntimeError, match="CUDA"):
        LM(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        SyntheticLMData.for_model(cfg, 2, 8).batch(0, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "mamba2-370m", "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "qwen3-1.7b", "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "qwen3-1.7b", "--smoke", "--mode", "ol4el"])


def test_bench_entry_points_default_to_cuda(monkeypatch, tmp_path):
    from repro_torch.bench import churn_baselines, policy_ablation, run
    from repro_torch.bench import testbed
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "bench.json"
    with pytest.raises(RuntimeError, match="CUDA"):
        run.main(["--fast", "--only", "fig5", "--out", str(out)])
    with pytest.raises(RuntimeError, match="CUDA"):
        policy_ablation.main(["--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        churn_baselines.main(["--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        testbed.main(["--samples", "600"])
    assert not out.exists()


def test_examples_and_the_planners_measure_default_to_cuda(monkeypatch,
                                                          tmp_path):
    """The examples run on the card unless given ``--device cpu``; the
    planner traces on ``meta`` tensors, and its ``--measure`` runs on a
    card or nowhere."""
    from repro_torch.examples import quickstart, serve_batched, \
        train_lm_ol4el
    from repro_torch.launch import dryrun
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (quickstart.main, serve_batched.main, train_lm_ol4el.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main([])
    out = tmp_path / "rows.jsonl"
    with pytest.raises(SystemExit):
        dryrun.main(["--measure", "--out", str(out)])
    with pytest.raises(ValueError, match="card"):
        dryrun.plan_combo("mamba2-370m", "long_500k", measure=True,
                          device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.plan_combo("mamba2-370m", "long_500k", measure=True,
                          device="cuda")
    assert not out.exists()


def test_cpu_model_takes_the_plain_ssd_and_cuda_the_kernel(monkeypatch):
    """``use_ssd_kernel=None`` resolves from the device: the kernel on a
    CUDA device, the plain SSD on the CPU; an explicit value wins."""
    from repro_torch.config import get_smoke_config
    from repro_torch.models import LM
    cfg = get_smoke_config("mamba2-370m").model
    assert LM(cfg, device="cpu").use_ssd_kernel is False
    assert LM(cfg, use_ssd_kernel=True, device="cpu").use_ssd_kernel is True
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert LM(cfg, device="cuda").use_ssd_kernel is True
    assert LM(cfg, use_ssd_kernel=False,
              device="cuda").use_ssd_kernel is False


def test_cpu_model_takes_plain_attention_and_cuda_the_kernel(monkeypatch):
    """``attn_impl=None`` resolves from the device: the flash_attention
    kernel on a CUDA device, the reference's auto rule on the CPU; an
    explicit value wins."""
    from repro_torch.config import get_smoke_config
    from repro_torch.models import LM
    cfg = get_smoke_config("qwen3-1.7b").model
    assert LM(cfg, device="cpu").attn_impl == "auto"
    assert LM(cfg, attn_impl="kernel", device="cpu").attn_impl == "kernel"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert LM(cfg, device="cuda").attn_impl == "kernel"
    assert LM(cfg, attn_impl="naive", device="cuda").attn_impl == "naive"


class FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach an op's card path
    without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake_cuda(*shape, dtype=torch.float32):
    return torch.zeros(*shape, dtype=dtype).as_subclass(FakeCuda)


def test_flash_op_never_runs_the_plain_version_for_a_cuda_tensor(
        monkeypatch):
    from repro_torch.kernels.flash_attention import kernel, ops
    calls = []
    monkeypatch.setattr(kernel, "flash_fwd", lambda *a: calls.append(a))
    monkeypatch.setattr(ops, "attention_ref", lambda *a, **k: pytest.fail(
        "plain attention ran for a CUDA tensor"))
    monkeypatch.setattr(torch, "empty_like", lambda t: _fake_cuda(*t.shape))
    before = ops.launches
    ops.flash_attention(_fake_cuda(1, 64, 4, 64), _fake_cuda(1, 64, 2, 64),
                        _fake_cuda(1, 64, 2, 64), window=16)
    assert len(calls) == 1 and ops.launches == before + 1
    assert calls[0][3:5] == (True, 16)


def test_ssd_op_never_runs_the_plain_version_for_a_cuda_tensor(monkeypatch):
    """On a CUDA tensor the op goes to the kernel (or raises): stub the
    launch and check it, not the plain version, is reached."""
    from repro_torch.kernels.ssd_scan import kernel, ops
    calls = []
    monkeypatch.setattr(kernel, "ssd_fwd", lambda *a: calls.append(a))
    monkeypatch.setattr(ops, "ssd_reference", lambda *a: pytest.fail(
        "plain SSD ran for a CUDA tensor"))

    fake = _fake_cuda
    monkeypatch.setattr(torch, "empty_like", lambda t: fake(*t.shape))
    monkeypatch.setattr(torch, "empty", lambda *s, **k: fake(*s))
    before = ops.launches
    ops.ssd(fake(1, 64, 2, 16), fake(1, 64, 2), fake(1, 64, 8),
            fake(1, 64, 8), 32)
    assert len(calls) == 1 and ops.launches == before + 1


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    """Without a card (and outside a checkout) the script fails and
    prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", lone):
        out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                             capture_output=True, text=True, timeout=300,
                             env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_ssd_kernel_path_refuses_inputs_that_need_a_gradient(monkeypatch):
    """The ssd_scan kernel has no backward, and the op needs none: on CUDA
    tensors that need a gradient the forward launches the (stubbed)
    kernel exactly once, and the backward returns the plain
    ``ssd_reference``'s gradients for the cotangents of both outputs."""
    from repro_torch.kernels.ssd_scan import kernel, ops, ref
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((1, 64, 2, 16), (1, 64, 2), (1, 64, 8), (1, 64, 8))]
    arrays[1] = -np.abs(arrays[1])
    cts = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
           for s in ((1, 64, 2, 16), (1, 2, 16, 8))]
    plain = [torch.from_numpy(a).requires_grad_() for a in arrays]
    want = torch.autograd.grad(ref.ssd_reference(*plain, 32), plain, cts)

    def fake(a):
        return torch.from_numpy(a).as_subclass(FakeCuda).requires_grad_()
    calls = []
    monkeypatch.setattr(kernel, "ssd_fwd", lambda *a: calls.append(a))
    monkeypatch.setattr(torch, "empty_like", lambda t: _fake_cuda(*t.shape))
    monkeypatch.setattr(torch, "empty", lambda *s, **k: _fake_cuda(*s))
    # the backward's plain version, on the tensors' CPU storage
    monkeypatch.setattr(ops, "ssd_reference", lambda *a: ref.ssd_reference(
        *(t.as_subclass(torch.Tensor) for t in a[:4]), *a[4:]))
    tensors = [fake(a) for a in arrays]
    before = ops.launches
    y, state = ops.ssd(*tensors, 32)
    assert len(calls) == 1 and ops.launches == before + 1
    got = torch.autograd.grad((y, state), tensors, cts)
    assert len(calls) == 1 and ops.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.as_subclass(torch.Tensor), w)

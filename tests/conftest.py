"""Shared pytest fixtures.

NOTE: no XLA_FLAGS manipulation here — smoke tests and benches must see the
single real CPU device.  Multi-device tests spawn subprocesses that set
``--xla_force_host_platform_device_count`` themselves (see
``tests/test_dryrun.py``).
"""

import os
import sys
import types

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

jax.config.update("jax_enable_x64", False)


# ---------------------------------------------------------------------------
# Optional-dependency shim: `hypothesis` is dev-only (requirements-dev.txt).
# When it is absent, install a stub whose @given marks the test skipped, so
# every module still collects and the non-property tests run.
# ---------------------------------------------------------------------------

try:
    import hypothesis  # noqa: F401
except ImportError:
    def _skip_given(*_args, **_kwargs):
        def deco(fn):
            return pytest.mark.skip(
                reason="hypothesis not installed (see requirements-dev.txt)"
            )(fn)
        return deco

    def _passthrough_settings(*_args, **_kwargs):
        def deco(fn):
            return fn
        return deco

    class _AnyStrategy:
        def __getattr__(self, name):
            return lambda *a, **k: self
        def __call__(self, *a, **k):
            return self

    _stub = types.ModuleType("hypothesis")
    _stub.given = _skip_given
    _stub.settings = _passthrough_settings
    _stub.strategies = _AnyStrategy()
    _stub.__stub__ = True
    _strategies = types.ModuleType("hypothesis.strategies")
    _strategies.__getattr__ = lambda name: _AnyStrategy()
    sys.modules["hypothesis"] = _stub
    sys.modules["hypothesis.strategies"] = _strategies


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one); run on the "
        "card with `python -m pytest --noconftest -m cuda "
        "tests/test_torch_kernels_cuda.py`")


@pytest.fixture(scope="session")
def rng():
    return jax.random.key(0)


@pytest.fixture()
def np_rng():
    return np.random.default_rng(0)


def assert_finite(tree, name="tree"):
    import jax.numpy as jnp
    for i, leaf in enumerate(jax.tree.leaves(tree)):
        assert bool(jnp.all(jnp.isfinite(leaf.astype(jnp.float32)))), \
            f"non-finite values in {name} leaf {i}"

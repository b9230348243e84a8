"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither jax nor the JAX package, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_kernels_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import get_config  # noqa: E402
from repro_torch.kernels.kmeans_assign import ops, ref  # noqa: E402
from repro_torch.models import KMeans  # noqa: E402

pytestmark = pytest.mark.cuda

# the reference's tests/test_kernels.py cases, then the main path's
# local-step minibatch and evaluation-set shapes
KM_CASES = [
    (100, 8, 3, "float32"),
    (1000, 64, 3, "float32"),
    (513, 59, 8, "float32"),
    (256, 16, 32, "float32"),
    (300, 64, 3, "bfloat16"),
    (128, 64, 3, "float32"),
    (4000, 64, 3, "float32"),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `PYTHONPATH=src python -m pytest "
                    "--noconftest -m cuda tests/test_torch_kernels_cuda.py` "
                    "on the card")
    return torch.device("cuda")


def _inputs(n, d, k, dtype, seed, device):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((n, d)), dtype=torch.float32)
    c = torch.tensor(rng.standard_normal((k, d)), dtype=torch.float32)
    dt = getattr(torch, dtype)
    return x.to(device, dt), c.to(device, dt)


@pytest.mark.parametrize("n,d,k,dtype", KM_CASES)
def test_kmeans_assign_matches_plain(n, d, k, dtype, cuda_device):
    x, c = _inputs(n, d, k, dtype, n + d + k, cuda_device)
    before = ops.launches
    a, d2 = ops.assign_with_dist(x, c)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert a.dtype == torch.int32 and d2.dtype == torch.float32
    a_ref, d2_ref = ref.assign_ref(x, c)
    # f32: both sides sum terms of size ||x||^2 ~ D in different orders;
    # bf16: the reference test's bound
    rtol, atol = (1e-4, 1e-3) if dtype == "float32" else (1e-2, 1e-2)
    torch.testing.assert_close(d2, d2_ref, rtol=rtol, atol=atol)
    if dtype == "float32":
        assert float((a == a_ref).float().mean()) >= 0.999


def test_kmeans_assign_tie_goes_to_lowest_index(cuda_device):
    x, c = _inputs(1000, 64, 4, "float32", 5, cuda_device)
    c[2] = c[0]
    c[3] = c[1]
    a, _ = ops.assign_with_dist(x, c)
    a_ref, _ = ref.assign_ref(x, c)
    torch.cuda.synchronize()
    assert not bool(((a == 2) | (a == 3)).any())
    assert torch.equal(a, a_ref)


def test_kmeans_assign_empty_input_does_not_launch(cuda_device):
    x, c = _inputs(0, 64, 3, "float32", 0, cuda_device)
    before = ops.launches
    a, d2 = ops.assign_with_dist(x, c)
    assert ops.launches == before and a.shape == (0,) and d2.shape == (0,)


def test_kmeans_assign_rejects_what_the_kernel_cannot_take(cuda_device):
    x, c = _inputs(64, 64, 3, "float32", 1, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ops.assign_with_dist(x.T.contiguous().T, c)
    big = torch.zeros(1000, 64, device=cuda_device)   # 256 KB of centroids
    with pytest.raises(ValueError, match="shared memory"):
        ops.assign_with_dist(x, big)


def test_kmeans_cuda_local_step_matches_plain_step(cuda_device):
    cfg = get_config("kmeans-traffic").model
    cuda_model = KMeans(cfg, impl="cuda", device=cuda_device)
    plain_model = KMeans(cfg, impl="torch", device=cuda_device)
    params = cuda_model.init(torch.Generator().manual_seed(3))
    x, _ = _inputs(128, 64, 1, "float32", 9, cuda_device)
    before = ops.launches
    p_cuda, _ = cuda_model.local_step(params, {"x": x}, 1.0)
    p_plain, _ = plain_model.local_step(params, {"x": x}, 1.0)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    torch.testing.assert_close(p_cuda["centers"], p_plain["centers"],
                               rtol=1e-5, atol=1e-5)

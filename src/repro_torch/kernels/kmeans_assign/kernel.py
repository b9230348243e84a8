"""ctypes binding of the Hopper K-means assignment kernel.

The kernel itself is CUDA C++ in ``repro_torch/csrc/kmeans_assign.cu``
(see its header for the design and what bounds it); this module builds
it on first use, declares its C signature and launches it.  Shape and
dtype checks live in the ``ops`` wrapper.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

SOURCES = ("kmeans_assign.cu",)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ROWS = 128                     # points per block, one per thread


def library_path():
    """Build if needed; the shared library's path (its ``.log`` beside)."""
    return _build.library_path("kmeans_assign", SOURCES)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = _build.load("kmeans_assign", SOURCES)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.kmeans_assign_launch.argtypes = [vp, vp, ci, ci, ci, ci, ci, ci,
                                         vp, vp, vp]
    lib.kmeans_assign_launch.restype = ci
    lib.kmeans_assign_max_smem.argtypes = [ci, ctypes.POINTER(ci)]
    lib.kmeans_assign_max_smem.restype = ci
    lib.kmeans_assign_error_string.argtypes = [ci]
    lib.kmeans_assign_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.kmeans_assign_error_string(err).decode()
        raise RuntimeError(f"kmeans_assign {what} failed: CUDA error {err} "
                           f"({msg})")


@functools.lru_cache(maxsize=None)
def tile(d: int, k: int, device_index: int) -> tuple:
    """(rows, x_stride) of a block for feature dim ``d`` and ``k`` centres.

    The tile is halved from ``ROWS`` down to one warp until centroids,
    their norms and the staged point tile fit the block's shared memory.
    Raises when ``k * d`` leaves no room for even one warp of points.
    """
    lib = library()
    limit = ctypes.c_int(0)
    _check(lib, lib.kmeans_assign_max_smem(device_index, ctypes.byref(limit)),
           "shared-memory query")
    x_stride = d if d % 2 else d + 1          # odd stride: no bank conflicts
    rows = ROWS
    while rows >= 32:
        if 4 * (k * d + k + rows * x_stride) <= limit.value:
            return rows, x_stride
        rows //= 2
    raise ValueError(
        f"kmeans_assign: K*D = {k}*{d} centroids do not fit one block's "
        f"{limit.value} bytes of shared memory beside a 32-point tile")


def assign_fwd(x: torch.Tensor, centers: torch.Tensor,
               out_assign: torch.Tensor, out_d2: torch.Tensor) -> None:
    """Launch on the current stream: x [N, D], centers [K, D] (contiguous,
    same CUDA device, f32 or bf16) into out_assign [N] i32, out_d2 [N] f32."""
    n, d = x.shape
    k = centers.shape[0]
    rows, x_stride = tile(d, k, x.device.index)
    lib = library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.kmeans_assign_launch(
        x.data_ptr(), centers.data_ptr(), n, d, k, _DTYPE_CODE[x.dtype],
        rows, x_stride, out_assign.data_ptr(), out_d2.data_ptr(), stream)
    _check(lib, err, "launch")

"""ctypes binding of the Hopper K-means assignment kernel.

The kernel itself is CUDA C++ in ``repro_torch/csrc/kmeans_assign.cu``
(see its header for the design and what bounds it); this module builds
it on first use, declares its C signature, plans a shape (lanes per
point, and the centres a block holds in shared memory at once) and
launches it.  Shape and dtype checks live in the ``ops`` wrapper.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build

SOURCES = ("kmeans_assign.cu",)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 128                  # threads per block (the .cu's kThreads)
LANE_ELEMS = 8                 # elements of a point a lane keeps in registers
MAX_D = 4096                   # the features a point may have, at most


def library_path():
    """Build if needed; the shared library's path (its ``.log`` beside)."""
    return _build.library_path("kmeans_assign", SOURCES)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = _build.load("kmeans_assign", SOURCES)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.kmeans_assign_launch.argtypes = [vp, vp, ci, ci, ci, ci, ci, ci, ci,
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


def lane_group(d: int) -> int:
    """Lanes that share one point: the least power of two that leaves at
    most ``LANE_ELEMS`` elements of D to a lane, at most a warp (8 at
    D = 64, 1 at D <= 8)."""
    group = 1
    while group < 32 and group * LANE_ELEMS < d:
        group *= 2
    return group


def smem_bytes(d: int, k: int) -> int:
    """Dynamic shared memory of one block holding ``k`` centroids: the
    centroids [k, D] and their norms [k], in f32."""
    return 4 * (k * d + k)


@functools.lru_cache(maxsize=None)
def plan(d: int, k: int, limit: int) -> Tuple[int, int]:
    """(lanes per point, centres a tile) for feature dim ``d`` and ``k``
    centres under ``limit`` bytes of shared memory: a block holds
    ``THREADS`` // lanes points and walks the centres in tiles of that
    many rows, as few tiles as fit, of even size (one tile, all K, where
    they fit).  Cached: the EL loop launches at a few shapes thousands of
    times.  Raises past ``MAX_D``."""
    if d > MAX_D:
        raise ValueError(f"kmeans_assign: D = {d} exceeds the kernel's "
                         f"{MAX_D} features")
    tiles = -(-k // (limit // smem_bytes(d, 1)))
    return lane_group(d), -(-k // tiles)


@functools.lru_cache(maxsize=None)
def max_smem(device_index: int) -> int:
    lib = library()
    limit = ctypes.c_int(0)
    _check(lib, lib.kmeans_assign_max_smem(device_index, ctypes.byref(limit)),
           "shared-memory query")
    return limit.value


def _launch(x: torch.Tensor, centers: torch.Tensor, edges: int,
            out_assign: torch.Tensor, out_d2: torch.Tensor) -> None:
    n, d = x.shape[-2:]
    k = centers.shape[-2]
    group, tile = plan(d, k, max_smem(x.device.index))
    lib = library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.kmeans_assign_launch(
        x.data_ptr(), centers.data_ptr(), edges, n, d, k, tile,
        _DTYPE_CODE[x.dtype], group, out_assign.data_ptr(),
        out_d2.data_ptr(), stream)
    _check(lib, err, "launch")


def assign_fwd(x: torch.Tensor, centers: torch.Tensor,
               out_assign: torch.Tensor, out_d2: torch.Tensor) -> None:
    """Launch on the current stream: x [N, D], centers [K, D] (contiguous,
    same CUDA device, f32 or bf16) into out_assign [N] i32, out_d2 [N] f32."""
    _launch(x, centers, 1, out_assign, out_d2)


def assign_fwd_batched(x: torch.Tensor, centers: torch.Tensor,
                       out_assign: torch.Tensor,
                       out_d2: torch.Tensor) -> None:
    """Launch once on the current stream for every edge: x [E, N, D],
    centers [E, K, D] (contiguous, same CUDA device, f32 or bf16) into
    out_assign [E, N] i32, out_d2 [E, N] f32.  Under CUDA-graph capture
    the current stream is the capturing one, so the launch is recorded
    into the graph; ``library()`` and ``max_smem`` must have run once
    before capture (they load the library and query the device)."""
    _launch(x, centers, x.shape[0], out_assign, out_d2)

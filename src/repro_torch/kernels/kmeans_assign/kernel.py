"""ctypes binding of the Hopper K-means assignment kernel.

The kernel itself is CUDA C++ in ``repro_torch/csrc/kmeans_assign.cu``
(see its header for the design and what bounds it); this module builds
it on first use, declares its C signature, plans a shape (which of its
two instances runs it: the lane-group kernel, with its lanes per point,
or the block-tiled kernel) and launches it.  Shape and dtype checks live
in the ``ops`` wrapper.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

SOURCES = ("kmeans_assign.cu",)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
THREADS = 128                  # threads per block (the .cu's kThreads)
LANE_ELEMS = 8                 # elements of a point a lane keeps in registers
LANES_MAX_D = 32 * LANE_ELEMS  # the widest point a lane group holds: 256
BLOCK_POINTS = 64              # block-tiled instance: points a block (kBM)
BLOCK_CENTRES = 64             # and centres a tile (kBK)


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
    lib.kmeans_assign_block_launch.argtypes = [vp, vp, ci, ci, ci, ci, ci,
                                               vp, vp, vp]
    lib.kmeans_assign_block_launch.restype = ci
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


class Plan(NamedTuple):
    """How the kernel runs one shape (``plan``)."""
    block: bool     # the block-tiled instance (else the lane-group one)
    group: int      # lane group: lanes per point (block-tiled: 0)
    tile: int       # centres a block holds at once (lane group: all K)


@functools.lru_cache(maxsize=None)
def plan(d: int, k: int, limit: int) -> Plan:
    """The instance for feature dim ``d`` and ``k`` centres under
    ``limit`` bytes of shared memory: the lane-group kernel, all K
    centres staged in one block and ``lane_group(d)`` lanes a point,
    where they fit and a group's registers hold the point (D <= 256);
    else the block-tiled kernel (``BLOCK_POINTS`` points against tiles
    of ``BLOCK_CENTRES`` centres, D in slices), which takes any D and K.
    Cached: the EL loop launches at a few shapes thousands of times."""
    if d <= LANES_MAX_D and smem_bytes(d, k) <= limit:
        return Plan(False, lane_group(d), k)
    return Plan(True, 0, BLOCK_CENTRES)


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
    run = plan(d, k, max_smem(x.device.index))
    lib = library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if run.block:
        err = lib.kmeans_assign_block_launch(
            x.data_ptr(), centers.data_ptr(), edges, n, d, k,
            _DTYPE_CODE[x.dtype], out_assign.data_ptr(), out_d2.data_ptr(),
            stream)
    else:
        err = lib.kmeans_assign_launch(
            x.data_ptr(), centers.data_ptr(), edges, n, d, k,
            _DTYPE_CODE[x.dtype], run.group, out_assign.data_ptr(),
            out_d2.data_ptr(), stream)
    _check(lib, err, "launch")


def assign_fwd(x: torch.Tensor, centers: torch.Tensor,
               out_assign: torch.Tensor, out_d2: torch.Tensor) -> None:
    """Launch on the current stream: x [N, D], centers [K, D] (contiguous,
    same CUDA device, f32, bf16 or f16) into out_assign [N] i32, out_d2
    [N] f32."""
    _launch(x, centers, 1, out_assign, out_d2)


def assign_fwd_batched(x: torch.Tensor, centers: torch.Tensor,
                       out_assign: torch.Tensor,
                       out_d2: torch.Tensor) -> None:
    """Launch once on the current stream for every edge: x [E, N, D],
    centers [E, K, D] (contiguous, same CUDA device, f32, bf16 or f16) into
    out_assign [E, N] i32, out_d2 [E, N] f32.  Under CUDA-graph capture
    the current stream is the capturing one, so the launch is recorded
    into the graph; ``library()`` and ``max_smem`` must have run once
    before capture (they load the library and query the device)."""
    _launch(x, centers, x.shape[0], out_assign, out_d2)

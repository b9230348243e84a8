"""Public K-means assignment op (forward only; the E-step has no grad).

``assign_with_dist`` picks its path from where the tensors lie: on a CUDA
device it launches the hand-written kernel (``kernel.assign_fwd``) or
raises; on the CPU it runs the plain version ``ref.assign_ref``.  It never
runs the plain version for a CUDA tensor.

``launches`` counts kernel launches (CPU calls and empty inputs do not
launch), so a run can show that its E-steps went through the kernel.

``assign_with_dist_batched`` is the same op for E edges at once,
x [E, N, D] against each edge's own centres [E, K, D] (the reference's
kernel under ``jax.vmap``), one launch for all edges, counted apart in
``batched_launches``.  Inside a CUDA graph capture the wrapper records a
launch but runs none: it counts it in ``batched_captured``, and whoever
replays the graph adds (replays x launches captured) to
``batched_launches`` through ``add_replayed``.

The batched entry is the registered op ``repro_torch::kmeans_assign_batched``
with a ``torch.func.vmap`` rule: under a vmap over cells the rule folds
the cell dimension into the edge dimension (``[C, E, N, D]`` into
``[C * E, N, D]``), calls the op once and unfolds the outputs, so a sweep's
local step is still one launch for every (cell, edge) pair; nested vmaps
fold one dimension at a time.  The kernel's grid takes at most
``MAX_EDGES`` such pairs.

On ``meta`` tensors both entries allocate the kernel's outputs, compute
nothing, launch nothing and add the kernel's ``work`` to ``meta_flops`` /
``meta_bytes``, as the other kernels' wrappers do for the planner.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.kmeans_assign import kernel
from repro_torch.kernels.kmeans_assign.ref import assign_ref

#: The float dtypes the op takes (the kernel upcasts each to f32 on load)
DTYPES = (torch.float32, torch.bfloat16, torch.float16)

#: The most (cell, edge) pairs one batched launch takes: the kernel's
#: ``gridDim.y`` is the edge.
MAX_EDGES = 65_535

launches = 0
batched_launches = 0
batched_captured = 0
meta_flops = 0
meta_bytes = 0


def work(n: int, d: int, k: int, e: int = 1, element_size: int = 4
         ) -> Tuple[int, int]:
    """(operations, bytes) of one call over ``e`` edges: x and the centres
    read once, the assignments (i32) and distances (f32) written once;
    the distance expansion (2NKD), the norms (2ND + 2KD) and the combine
    and minimum (3NK)."""
    nbytes = e * ((n * d + k * d) * element_size + n * (4 + 4))
    flops = e * (2 * n * k * d + 2 * n * d + 2 * k * d + 3 * n * k)
    return flops, nbytes


def _meta_outputs(x: torch.Tensor, centers: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The outputs' shapes and dtypes, with the call's work counted."""
    global meta_flops, meta_bytes
    *lead, n, d = x.shape
    flops, nbytes = work(n, d, centers.shape[-2],
                         x.shape[0] if lead else 1, x.element_size())
    meta_flops += flops
    meta_bytes += nbytes
    return (x.new_empty((*lead, n), dtype=torch.int32),
            x.new_empty((*lead, n), dtype=torch.float32))


def _check_shapes(x: torch.Tensor, centers: torch.Tensor) -> None:
    if x.dim() != 2 or centers.dim() != 2 or x.shape[1] != centers.shape[1]:
        raise ValueError(f"kmeans_assign: x [N, D] and centers [K, D] "
                         f"expected, got {tuple(x.shape)} and "
                         f"{tuple(centers.shape)}")


def _check_batched_shapes(x: torch.Tensor, centers: torch.Tensor) -> None:
    if x.dim() != 3 or centers.dim() != 3 or x.shape[0] != centers.shape[0] \
            or x.shape[2] != centers.shape[2]:
        raise ValueError(f"kmeans_assign: x [E, N, D] and centers [E, K, D] "
                         f"expected, got {tuple(x.shape)} and "
                         f"{tuple(centers.shape)}")


def _check(x: torch.Tensor, centers: torch.Tensor) -> None:
    if centers.shape[-2] < 1:
        raise ValueError("kmeans_assign: need at least one centre")
    if x.dtype not in DTYPES or centers.dtype != x.dtype:
        raise TypeError(f"kmeans_assign: x and centers must share dtype "
                        f"float32, bfloat16 or float16, got {x.dtype} and "
                        f"{centers.dtype}")
    if x.device != centers.device:
        raise ValueError(f"kmeans_assign: x on {x.device}, centers on "
                         f"{centers.device}")


def _check_cuda(x: torch.Tensor, centers: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"kmeans_assign: no path for device {x.device}")
    if not (x.is_contiguous() and centers.is_contiguous()):
        raise ValueError("kmeans_assign: x and centers must be contiguous")


def assign_with_dist(x: torch.Tensor, centers: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [N, D]; centers: [K, D] -> (assignments [N] i32, min_d2 [N] f32)."""
    global launches
    _check_shapes(x, centers)
    _check(x, centers)
    if x.device.type == "cpu":
        return assign_ref(x, centers)
    if x.device.type == "meta":
        return _meta_outputs(x, centers)
    _check_cuda(x, centers)
    n = x.shape[0]
    out_assign = torch.empty(n, dtype=torch.int32, device=x.device)
    out_d2 = torch.empty(n, dtype=torch.float32, device=x.device)
    if n:
        kernel.assign_fwd(x, centers, out_assign, out_d2)
        launches += 1
    return out_assign, out_d2


def assign(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    return assign_with_dist(x, centers)[0]


def assign_with_dist_batched(x: torch.Tensor, centers: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [E, N, D]; centers: [E, K, D] -> (assignments [E, N] i32,
    min_d2 [E, N] f32), edge e's points against edge e's centres."""
    _check_batched_shapes(x, centers)
    _check(x, centers)
    if x.device.type == "meta":
        return _meta_outputs(x, centers)
    return _assign_batched(x, centers)


@torch.library.custom_op("repro_torch::kmeans_assign_batched",
                         mutates_args=())
def _assign_batched(x: torch.Tensor, centers: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    global batched_launches, batched_captured
    if x.device.type == "cpu":
        return assign_ref(x, centers)
    _check_cuda(x, centers)
    e, n = x.shape[:2]
    if e > MAX_EDGES:
        raise ValueError(f"kmeans_assign: {e} (cell, edge) pairs in one "
                         f"batched launch; the kernel's grid takes at most "
                         f"{MAX_EDGES}")
    out_assign = torch.empty(e, n, dtype=torch.int32, device=x.device)
    out_d2 = torch.empty(e, n, dtype=torch.float32, device=x.device)
    if e and n:
        kernel.assign_fwd_batched(x, centers, out_assign, out_d2)
        if torch.cuda.is_current_stream_capturing():
            batched_captured += 1
        else:
            batched_launches += 1
    return out_assign, out_d2


@_assign_batched.register_fake
def _assign_batched_fake(x: torch.Tensor, centers: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    e, n = x.shape[:2]
    return (x.new_empty((e, n), dtype=torch.int32),
            x.new_empty((e, n), dtype=torch.float32))


def _fold(t: torch.Tensor, dim: Optional[int], size: int) -> torch.Tensor:
    """The vmapped dimension ``dim`` (None: unbatched, expanded) folded
    into the edge dimension: [size, E, ...] as [size * E, ...]."""
    t = t.expand(size, *t.shape) if dim is None else t.movedim(dim, 0)
    return t.reshape(-1, *t.shape[2:]).contiguous()


@_assign_batched.register_vmap
def _assign_batched_vmap(info, in_dims, x: torch.Tensor,
                         centers: torch.Tensor):
    size = info.batch_size
    a, d2 = _assign_batched(_fold(x, in_dims[0], size),
                            _fold(centers, in_dims[1], size))
    return (a.reshape(size, -1, a.shape[-1]),
            d2.reshape(size, -1, d2.shape[-1])), (0, 0)


def add_replayed(n: int) -> None:
    """Count ``n`` batched launches that a CUDA graph replay ran."""
    global batched_launches
    batched_launches += n

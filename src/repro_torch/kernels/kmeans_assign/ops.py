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
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.kmeans_assign import kernel
from repro_torch.kernels.kmeans_assign.ref import assign_ref

launches = 0
batched_launches = 0
batched_captured = 0


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
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or centers.dtype != x.dtype:
        raise TypeError(f"kmeans_assign: x and centers must share dtype "
                        f"float32 or bfloat16, got {x.dtype} and "
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
    global batched_launches, batched_captured
    _check_batched_shapes(x, centers)
    _check(x, centers)
    if x.device.type == "cpu":
        return assign_ref(x, centers)
    _check_cuda(x, centers)
    e, n = x.shape[:2]
    out_assign = torch.empty(e, n, dtype=torch.int32, device=x.device)
    out_d2 = torch.empty(e, n, dtype=torch.float32, device=x.device)
    if e and n:
        kernel.assign_fwd_batched(x, centers, out_assign, out_d2)
        if torch.cuda.is_current_stream_capturing():
            batched_captured += 1
        else:
            batched_launches += 1
    return out_assign, out_d2


def add_replayed(n: int) -> None:
    """Count ``n`` batched launches that a CUDA graph replay ran."""
    global batched_launches
    batched_launches += n

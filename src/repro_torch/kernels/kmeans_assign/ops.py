"""Public K-means assignment op (forward only; the E-step has no grad).

``assign_with_dist`` picks its path from where the tensors lie: on a CUDA
device it launches the hand-written kernel (``kernel.assign_fwd``) or
raises; on the CPU it runs the plain version ``ref.assign_ref``.  It never
runs the plain version for a CUDA tensor.

``launches`` counts kernel launches (CPU calls and empty inputs do not
launch), so a run can show that its E-steps went through the kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.kmeans_assign import kernel
from repro_torch.kernels.kmeans_assign.ref import assign_ref

launches = 0


def _check(x: torch.Tensor, centers: torch.Tensor) -> None:
    if x.dim() != 2 or centers.dim() != 2 or x.shape[1] != centers.shape[1]:
        raise ValueError(f"kmeans_assign: x [N, D] and centers [K, D] "
                         f"expected, got {tuple(x.shape)} and "
                         f"{tuple(centers.shape)}")
    if centers.shape[0] < 1:
        raise ValueError("kmeans_assign: need at least one centre")
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or centers.dtype != x.dtype:
        raise TypeError(f"kmeans_assign: x and centers must share dtype "
                        f"float32 or bfloat16, got {x.dtype} and "
                        f"{centers.dtype}")
    if x.device != centers.device:
        raise ValueError(f"kmeans_assign: x on {x.device}, centers on "
                         f"{centers.device}")


def assign_with_dist(x: torch.Tensor, centers: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [N, D]; centers: [K, D] -> (assignments [N] i32, min_d2 [N] f32)."""
    global launches
    _check(x, centers)
    if x.device.type == "cpu":
        return assign_ref(x, centers)
    if x.device.type != "cuda":
        raise ValueError(f"kmeans_assign: no path for device {x.device}")
    if not (x.is_contiguous() and centers.is_contiguous()):
        raise ValueError("kmeans_assign: x and centers must be contiguous")
    n = x.shape[0]
    out_assign = torch.empty(n, dtype=torch.int32, device=x.device)
    out_d2 = torch.empty(n, dtype=torch.float32, device=x.device)
    if n:
        kernel.assign_fwd(x, centers, out_assign, out_d2)
        launches += 1
    return out_assign, out_d2


def assign(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    return assign_with_dist(x, centers)[0]

"""Plain PyTorch version of the K-means assignment kernel.

The same formula as the reference's ``assign_ref`` and the CUDA kernel:
f32 ``d2 = ||x||^2 - 2 x.c + ||c||^2``, argmin (first index on ties) and
min.  The CPU path of the wrapper, the oracle the kernel is held to on
the card, and ``KMeans(impl="torch")``'s E-step.
"""

from __future__ import annotations

from typing import Tuple

import torch


def assign_ref(x: torch.Tensor, centers: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [N, D]; centers: [K, D] -> (assignments [N] i32, min_d2 [N] f32).

    Also the batched plain version: x [E, N, D] against centers
    [E, K, D], each edge against its own centres, gives [E, N] each (the
    reference's ``assign_fwd`` under ``jax.vmap`` over edges)."""
    x32 = x.float()
    c32 = centers.float()
    d2 = ((x32 ** 2).sum(-1, keepdim=True)
          - 2.0 * x32 @ c32.transpose(-1, -2)
          + (c32 ** 2).sum(-1).unsqueeze(-2))
    return d2.argmin(-1).to(torch.int32), d2.amin(-1)


def tolerance(dtype: torch.dtype) -> "tuple[float, float]":
    """(rtol, atol) the kernel's distances are held to: f32 inputs 1e-4
    and 1e-3 (the expansion cancels terms of size ||x||^2 ~ D, and the two
    sides sum in different orders); bf16 inputs 1e-2 each, the reference
    kernel test's tolerance.  f16 inputs (the reference's tests have
    none) start from the bf16 bound and take f32's, as far as the card
    showed it holds: both sides upcast to f32 on load, so the inputs are
    exact and only the summation order differs (an H100 gave f16 the
    errors it gave f32 at the same shapes; PERF.md)."""
    return (1e-2, 1e-2) if dtype == torch.bfloat16 else (1e-4, 1e-3)


def allowed_error(x: torch.Tensor, centers: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d2_plain, allowed): the plain version's distances and how far the
    kernel's may lie from them, ``atol + rtol * |d2_plain|`` elementwise
    at ``tolerance(x.dtype)``."""
    rtol, atol = tolerance(x.dtype)
    d2 = assign_ref(x, centers)[1]
    return d2, atol + rtol * d2.abs()

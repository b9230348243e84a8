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

"""Core layers of the LM stack: initialisers and RMSNorm.

Only what the Mamba path needs; attention, RoPE and the gated MLP come
with the attention slice.  Pure functions over plain dict trees, as in
the reference.  Initialisers draw from an explicit ``torch.Generator`` on
the generator's device and return f32 tensors there: the values differ
from ``jax.random``'s, the distributions do not.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

#: tensor-valued pytree of parameters (nested dicts / lists of tensors)
Params = dict


def dense_init(gen: torch.Generator, shape: Sequence[int],
               in_axis_size: int | None = None) -> torch.Tensor:
    """Truncated-normal fan-in init (1/sqrt(fan_in), cut at 2 sigma)."""
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    t = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(std)


def embed_init(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                       device=gen.device) * 0.02


def rms_norm(scale: torch.Tensor, x: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32 accumulation, cast back to the input dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def init_rms_norm(d: int, device: torch.device | str = "cpu"
                  ) -> torch.Tensor:
    # stored as (scale - 1) so zero-init == identity (gemma convention)
    return torch.zeros(d, dtype=torch.float32, device=device)

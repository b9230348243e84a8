"""Plain PyTorch version of the flash-attention kernel: causal GQA
attention with an optional sliding window, a line-for-line copy of the
reference's jnp oracle.

The CPU path of the wrapper, the backward of every path (as the
reference's ``custom_vjp`` routes gradients through its oracle), and the
version the kernel is held to on the card.  Logits and the softmax are
f32 (f64 for f64 inputs: the exact answer the card checks measure
rounding against); the probabilities are cast to q's dtype before the PV
product.
"""

from __future__ import annotations

from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, S, H, D]; k, v: [B, S, KV, D] -> [B, S, H, D].  The logits
    are divided by sqrt(D), or multiplied by ``scale`` where one is given
    (a head dim padded with zero columns keeps its own 1/sqrt(D))."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    f32 = torch.float64 if q.dtype == torch.float64 else torch.float32
    qg = q.reshape(b, s, kvh, g, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).to(f32)
    if scale is None:
        logits = logits / torch.sqrt(torch.tensor(d, dtype=f32))
    else:
        logits = logits * scale
    pos = torch.arange(s, device=q.device)
    ok = torch.ones(s, s, dtype=torch.bool, device=q.device)
    if causal:
        ok &= pos[None, :] <= pos[:, None]
    if window > 0:
        ok &= pos[None, :] > pos[:, None] - window
    logits = logits.masked_fill(~ok, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, d)


def tolerance(dtype: torch.dtype) -> float:
    """The elementwise bound, absolute and relative alike: the reference
    kernel test's 2e-2 for bf16 inputs and 2e-5 for f32.  f16 inputs
    (the reference's tests have none) start from the bf16 bound, halved
    as far as the card showed it holds: 1e-2, 5x the largest error an
    H100 gave at f16 (1.95e-3, one f16 ulp at |o| ~ 2; PERF.md); f16
    keeps 3 more mantissa bits than bf16, so P and o round finer."""
    if dtype == torch.bfloat16:
        return 2e-2
    return 1e-2 if dtype == torch.float16 else 2e-5


def allowed_error(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0):
    """What a kernel's attention is held to: the plain version's output
    and the per-element distance the kernel's may lie from it, the
    reference test's ``tolerance(q.dtype) * (1 + |plain|)``.

    Returns ``(plain, allowed)``, both f64."""
    plain = attention_ref(q, k, v, causal=causal, window=window).double()
    tol = tolerance(q.dtype)
    return plain, tol + tol * plain.abs()

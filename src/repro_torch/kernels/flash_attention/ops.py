"""Public flash-attention op: CUDA kernel forward, plain-version backward.

``flash_attention`` picks its forward from where the tensors lie: on a
CUDA device it launches the hand-written kernel (``kernel.flash_fwd``)
or raises; on the CPU it runs the plain version ``ref.attention_ref``.
It never runs the plain forward for a CUDA tensor.  The backward re-runs
``attention_ref`` under autograd and returns its gradients, as the
reference's ``custom_vjp`` routes them through its jnp oracle (the JAX
package has no backward kernel, so neither has the port).

``launches`` counts kernel launches (CPU calls and empty inputs do not
launch), so a run can show that its attention went through the kernel.
Under activation checkpointing the forward runs again in the backward's
recompute and counts again.

A head dim that is not one of the kernel's instances (``kernel.HEAD_DIMS``)
runs on the next larger one: the forward zero-pads q, k and v along D
(``kernel.pad_head_dim``), launches with the caller's scale 1/sqrt(D) and
slices the output back (``kernel.unpad``), which is exact.  Past the
largest instance (256) it raises.  The backward stays at the caller's D.

On ``meta`` tensors (the planner's shape-only trace,
``repro_torch.launch.dryrun``) the forward allocates what the card's path
does (the padded copies and the kernel's output), computes nothing,
launches nothing and adds the kernel's ``work`` at the caller's D to
``meta_flops`` / ``meta_bytes``: the planner counts what the function
needs (the attended pairs only), not the plain version's full square.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_ref

launches = 0
meta_flops = 0
meta_bytes = 0


def attended_pairs(s: int, window: int, causal: bool = True) -> int:
    """(query, key) pairs a sequence of ``s`` attends, with a sliding
    window of ``window`` keys (0: none): what the work needs, the masked
    pairs left out."""
    if causal:
        if window <= 0 or window >= s:
            return s * (s + 1) // 2
        return window * (window + 1) // 2 + (s - window) * window
    if window <= 0 or window >= s:
        return s * s
    return s * s - (s - window) * (s - window + 1) // 2


def work(b: int, s: int, h: int, kv: int, d: int, window: int = 0,
         element_size: int = 2, causal: bool = True) -> Tuple[int, int]:
    """(operations, bytes) of one call: QK^T and PV on the attended pairs
    (2 x 2 B H D a pair), q, k, v read once and o written once."""
    flops = 4 * b * h * d * attended_pairs(s, window, causal)
    nbytes = (2 * b * s * h * d + 2 * b * s * kv * d) * element_size
    return flops, nbytes


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention: q [B,S,H,D], k and v [B,S,KV,D] "
                         f"expected, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bsz, s, h, d = q.shape
    kvh = k.shape[2]
    if k.shape != v.shape or tuple(k.shape) != (bsz, s, kvh, d) \
            or kvh == 0 or h % kvh:
        raise ValueError(f"flash_attention: shapes disagree: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} (H must be a multiple of KV)")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k and v must share dtype "
                        f"float32 or bfloat16, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError("flash_attention: q, k and v on different devices")


def _forward(q, k, v, causal: bool, window: int) -> torch.Tensor:
    global launches, meta_flops, meta_bytes
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention: no path for device {q.device}")
    if q.device.type == "cuda" and not all(t.is_contiguous()
                                           for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    bsz, s, h, d = q.shape
    qp, kp, vp = kernel.pad_head_dim(q, k, v)
    out = torch.empty_like(qp)
    if q.device.type == "meta":
        flops, nbytes = work(bsz, s, h, k.shape[2], d, window,
                             q.element_size(), causal)
        meta_flops += flops
        meta_bytes += nbytes
    elif out.numel():
        kernel.flash_fwd(qp, kp, vp, causal, window, out,
                         1.0 / math.sqrt(d))
        launches += 1
    return kernel.unpad(out, d)


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _forward(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = attention_ref(q, k, v, causal=ctx.causal,
                                window=ctx.window)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), grad)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B,S,H,D]; k, v [B,S,KV,D] (H a multiple of KV) -> [B,S,H,D] in
    q's dtype.  Query i attends to key j when j <= i (``causal``) and
    ``i - window < j`` (``window > 0``); KV head ``h // (H / KV)``."""
    _check(q, k, v)
    return _FlashAttention.apply(q, k, v, bool(causal), int(window))

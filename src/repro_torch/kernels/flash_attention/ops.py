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
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_ref

launches = 0


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
    global launches
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no path for device {q.device}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    out = torch.empty_like(q)
    if out.numel():
        kernel.flash_fwd(q, k, v, causal, window, out)
        launches += 1
    return out


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

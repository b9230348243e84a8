"""Public SSD op: CUDA kernel forward, plain-version backward.

``ssd`` picks its forward from where the tensors lie: on a CUDA device it
launches the hand-written kernel (``kernel.ssd_fwd``) or raises; on the
CPU it runs the plain version ``ref.ssd_reference``.  It never runs the
plain forward for a CUDA tensor.  The backward re-runs ``ssd_reference``
under autograd and returns dx, dda, dB and dC from the cotangents of both
outputs, y and the final state, as the reference's ``custom_vjp`` routes
them through its jnp oracle (the JAX package has no backward kernel, so
neither has the port).

``launches`` counts kernel launches (CPU calls and empty inputs do not
launch), so a run can show that its prefills and training steps went
through the kernel.  Under activation checkpointing the forward runs
again in the backward's recompute and counts again.

The kernel takes any chunk dividing S and any P and N: it runs a chunk
above its 128 rows as sub-chunks (``kernel.plan``), N past 256 as parts
of at most 256 state columns whose y it sums in f32 (``kernel.split_n``),
and in bf16 and f16 the forward zero-pads P and N up to multiples of 16
(``kernel.pad_widths``) and slices y and the final state back
(``kernel.unpad``), which is exact.

On ``meta`` tensors (the planner's shape-only trace,
``repro_torch.launch.dryrun``) the forward allocates what the card's path
does (padded copies where bf16 pads, and the kernel's outputs), computes
nothing, launches nothing and adds the kernel's ``work`` at the caller's
widths to ``meta_flops`` / ``meta_bytes``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.ssd_scan import kernel
from repro_torch.kernels.ssd_scan.ref import ssd_reference

#: The dtypes of x, b and c the op takes (``kernel._DTYPE_CODE``'s)
DTYPES = (torch.float32, torch.bfloat16, torch.float16)

launches = 0
meta_flops = 0
meta_bytes = 0


def work(b: int, s: int, h: int, p: int, n: int, chunk: int,
         element_size: int = 2) -> Tuple[int, int]:
    """(operations, bytes) of one call.  Each input read once, each output
    written once; what the function needs, as multiply-adds (2 operations
    each), on the causal triangle of the L x L terms only: G = C B^T is
    shared by the heads, once per (b, chunk) (2 tri N); per (b, h, chunk)
    the masked Gd X (2 tri P), C state^T and the state update (2LPN
    each)."""
    nbytes = (2 * b * s * h * p * element_size + b * s * h * 4
              + 2 * b * s * n * element_size + b * h * p * n * 4)
    tri = chunk * (chunk + 1) // 2
    n_chunks = s // chunk
    flops = b * n_chunks * 2 * tri * n \
        + b * h * n_chunks * (2 * tri * p + 4 * chunk * p * n)
    return flops, nbytes


def _check(x, da, b_mat, c_mat, chunk: int) -> None:
    if x.dim() != 4 or da.dim() != 3 or b_mat.dim() != 3:
        raise ValueError(f"ssd_scan: x [B,S,H,P], da [B,S,H], b/c [B,S,N] "
                         f"expected, got {tuple(x.shape)}, {tuple(da.shape)},"
                         f" {tuple(b_mat.shape)}")
    bsz, s, h, _ = x.shape
    if tuple(da.shape) != (bsz, s, h) or b_mat.shape[:2] != (bsz, s) \
            or c_mat.shape != b_mat.shape:
        raise ValueError(f"ssd_scan: shapes disagree: x {tuple(x.shape)}, "
                         f"da {tuple(da.shape)}, b {tuple(b_mat.shape)}, "
                         f"c {tuple(c_mat.shape)}")
    if chunk < 1 or s % chunk:
        raise ValueError(f"ssd_scan: S={s} is not a multiple of chunk="
                         f"{chunk}")
    if x.dtype not in DTYPES or b_mat.dtype != x.dtype \
            or c_mat.dtype != x.dtype:
        raise TypeError(f"ssd_scan: x, b and c must share dtype float32, "
                        f"bfloat16 or float16, got {x.dtype}, "
                        f"{b_mat.dtype}, {c_mat.dtype}")
    if da.dtype != torch.float32:
        raise TypeError(f"ssd_scan: da must be float32, got {da.dtype}")
    if len({t.device for t in (x, da, b_mat, c_mat)}) != 1:
        raise ValueError("ssd_scan: x, da, b and c on different devices")


def _forward(x, da, b_mat, c_mat, chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    global launches, meta_flops, meta_bytes
    if x.device.type == "cpu":
        return ssd_reference(x, da, b_mat, c_mat, chunk)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd_scan: no path for device {x.device}")
    if x.device.type == "cuda" and not all(
            t.is_contiguous() for t in (x, da, b_mat, c_mat)):
        raise ValueError("ssd_scan: x, da, b and c must be contiguous")
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    x, b_mat, c_mat = kernel.pad_widths(x, b_mat, c_mat)
    y = torch.empty_like(x)
    final_state = torch.empty(bsz, h, x.shape[-1], b_mat.shape[-1],
                              dtype=torch.float32, device=x.device)
    if x.device.type == "meta":
        flops, nbytes = work(bsz, s, h, p, n, chunk, x.element_size())
        meta_flops += flops
        meta_bytes += nbytes
    elif y.numel() and final_state.numel():
        kernel.ssd_fwd(x, da, b_mat, c_mat, chunk, y, final_state)
        launches += 1
    else:                                  # nothing to scan or no state
        y.zero_()
        final_state.zero_()
    return kernel.unpad(y, final_state, p, n)


class _SSD(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, da, b_mat, c_mat, chunk):
        ctx.save_for_backward(x, da, b_mat, c_mat)
        ctx.chunk = chunk
        return _forward(x, da, b_mat, c_mat, chunk)

    @staticmethod
    def backward(ctx, dy, dstate):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y, final_state = ssd_reference(*inputs, ctx.chunk)
            grads = torch.autograd.grad((y, final_state), inputs,
                                        (dy, dstate))
        return (*grads, None)


def ssd(x: torch.Tensor, da: torch.Tensor, b_mat: torch.Tensor,
        c_mat: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,H,P] (pre-scaled by dt); da [B,S,H] f32; b/c [B,S,N]; S a
    multiple of ``chunk`` -> (y [B,S,H,P] in x's dtype, final_state
    [B,H,P,N] f32)."""
    _check(x, da, b_mat, c_mat, chunk)
    return _SSD.apply(x, da, b_mat, c_mat, int(chunk))

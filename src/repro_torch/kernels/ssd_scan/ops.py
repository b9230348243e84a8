"""Public SSD op (forward only; the backward comes with the mamba
training slice, and a CUDA call that would need one raises).

``ssd`` picks its path from where the tensors lie: on a CUDA device it
launches the hand-written kernel (``kernel.ssd_fwd``) or raises; on the
CPU it runs the plain version ``ref.ssd_reference``.  It never runs the
plain version for a CUDA tensor.

``launches`` counts kernel launches (CPU calls and empty inputs do not
launch), so a run can show that its prefills went through the kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.ssd_scan import kernel
from repro_torch.kernels.ssd_scan.ref import ssd_reference

launches = 0


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
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or b_mat.dtype != x.dtype or c_mat.dtype != x.dtype:
        raise TypeError(f"ssd_scan: x, b and c must share dtype float32 or "
                        f"bfloat16, got {x.dtype}, {b_mat.dtype}, "
                        f"{c_mat.dtype}")
    if da.dtype != torch.float32:
        raise TypeError(f"ssd_scan: da must be float32, got {da.dtype}")
    if len({t.device for t in (x, da, b_mat, c_mat)}) != 1:
        raise ValueError("ssd_scan: x, da, b and c on different devices")


def ssd(x: torch.Tensor, da: torch.Tensor, b_mat: torch.Tensor,
        c_mat: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,H,P] (pre-scaled by dt); da [B,S,H] f32; b/c [B,S,N]; S a
    multiple of ``chunk`` -> (y [B,S,H,P] in x's dtype, final_state
    [B,H,P,N] f32)."""
    global launches
    _check(x, da, b_mat, c_mat, chunk)
    if x.device.type == "cpu":
        return ssd_reference(x, da, b_mat, c_mat, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no path for device {x.device}")
    if chunk > kernel.MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk={chunk} exceeds the kernel's "
                         f"{kernel.MAX_CHUNK}")
    if not all(t.is_contiguous() for t in (x, da, b_mat, c_mat)):
        raise ValueError("ssd_scan: x, da, b and c must be contiguous")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, da, b_mat, c_mat)):
        raise NotImplementedError(
            "ssd_scan: the kernel has no backward yet (it comes with the "
            "mamba training slice); run the SSD forward-only or through "
            "the plain ssd_reference")
    bsz, _, h, p = x.shape
    y = torch.empty_like(x)
    final_state = torch.empty(bsz, h, p, b_mat.shape[-1],
                              dtype=torch.float32, device=x.device)
    if y.numel() and final_state.numel():
        kernel.ssd_fwd(x, da, b_mat, c_mat, chunk, y, final_state)
        launches += 1
    else:                                  # nothing to scan or no state
        y.zero_()
        final_state.zero_()
    return y, final_state

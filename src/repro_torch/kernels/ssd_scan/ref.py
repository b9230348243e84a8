"""Plain PyTorch version of the SSD scan kernel (Mamba-2's chunked dual
form), a line-for-line copy of the reference's jnp oracle.

The CPU path of the wrapper, the oracle the kernel is held to on the
card, and the mixer's SSD when ``use_kernel`` is false.  Nothing on the
card's main path runs it.  It computes in f32 from f32, bf16 or f16 inputs, as
the reference does, and in f64 from f64 inputs (the exact answer the
checks measure f32 rounding against).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def segsum(x: torch.Tensor) -> torch.Tensor:
    """Segment-sum: out[..., i, j] = sum_{k=j+1..i} x[..., k] (i >= j),
    -inf above the diagonal."""
    l = x.shape[-1]
    csum = torch.cumsum(x, dim=-1)
    out = csum[..., :, None] - csum[..., None, :]
    mask = torch.tril(torch.ones(l, l, dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd_reference(x: torch.Tensor, da: torch.Tensor, b_mat: torch.Tensor,
                  c_mat: torch.Tensor, chunk: int,
                  initial_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.

    x:  [B, S, H, P]  (pre-scaled by dt)
    da: [B, S, H]     (dt * A, negative)
    b_mat, c_mat: [B, S, N]  (single group, shared across heads)
    Returns (y [B, S, H, P] in x's dtype, final_state [B, H, P, N] f32,
    f64 for f64 inputs).  S must be divisible by ``chunk``.
    """
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    if s % chunk:
        raise ValueError(f"ssd_reference: S={s} is not a multiple of "
                         f"chunk={chunk}")
    c = s // chunk
    f32 = torch.float64 if x.dtype == torch.float64 else torch.float32
    xc = x.reshape(bsz, c, chunk, h, p).to(f32)
    bc = b_mat.reshape(bsz, c, chunk, n).to(f32)
    cc = c_mat.reshape(bsz, c, chunk, n).to(f32)
    a = da.reshape(bsz, c, chunk, h).permute(0, 3, 1, 2).to(f32)  # [B,H,C,L]
    a_cs = torch.cumsum(a, dim=-1)

    # 1) intra-chunk (diagonal blocks)
    decay = torch.exp(segsum(a))                                 # [B,H,C,L,L]
    y_diag = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp", cc, bc, decay, xc)

    # 2) per-chunk states
    decay_states = torch.exp(a_cs[..., -1:] - a_cs)              # [B,H,C,L]
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", bc, decay_states, xc)

    # 3) inter-chunk recurrence
    if initial_state is None:
        initial_state = torch.zeros(bsz, h, p, n, dtype=f32, device=x.device)
    states = torch.cat([initial_state[:, None].to(f32), states], dim=1)
    chunk_decay = a_cs[..., -1]                                  # [B,H,C]
    dc = torch.exp(segsum(torch.nn.functional.pad(chunk_decay, (1, 0))))
    new_states = torch.einsum("bhzc,bchpn->bzhpn", dc, states)  # [B,C+1,H,P,N]
    prev_states, final_state = new_states[:, :-1], new_states[:, -1]

    # 4) state -> output (off-diagonal contribution)
    out_decay = torch.exp(a_cs)                                  # [B,H,C,L]
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", cc, prev_states, out_decay)

    y = (y_diag + y_off).reshape(bsz, s, h, p)
    return y.to(x.dtype), final_state


def f32_rounding_bound(x: torch.Tensor, da: torch.Tensor, b_mat: torch.Tensor,
                       c_mat: torch.Tensor, chunk: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-element bound on how far an f32 evaluation of the SSD, in any
    summation order, can lie from its exact value: ``n * 2^-24`` times the
    SSD of ``|x|, |B|, |C|`` (evaluated in f64; the decays are positive,
    so that is the sum of the absolute values of every product term).
    ``n = S + 2N + L + 8`` is the longest chain of roundings feeding one
    output (the state over S steps, C.B and C.state over N, the
    intra-chunk sum over L, a few for exp and the scalings).  Two f32
    evaluations in different orders may differ by twice the bound."""
    s, n = x.shape[1], b_mat.shape[-1]
    y_abs, st_abs = ssd_reference(x.double().abs(), da.double(),
                                  b_mat.double().abs(), c_mat.double().abs(),
                                  chunk)
    u = (s + 2 * n + chunk + 8) * 2.0 ** -24
    return u * y_abs, u * st_abs


def tolerance(dtype: torch.dtype) -> float:
    """The elementwise tolerance, absolute and relative alike: the
    reference kernel test's 5e-2 for bf16 inputs and 1e-4 for f32.  f16
    inputs (the reference's tests have none) keep the bf16 bound: an H100
    gave f16 errors of up to 0.0625 on large y (one f16 ulp there), none
    past the bound, which is as far as it showed the bound holds."""
    if dtype in (torch.bfloat16, torch.float16):
        return 5e-2
    return 1e-4


def allowed_error(x: torch.Tensor, da: torch.Tensor, b_mat: torch.Tensor,
                  c_mat: torch.Tensor, chunk: int):
    """What a kernel's SSD is held to: the plain version's y and final
    state, each with the per-element distance the kernel's may lie from
    it, ``tolerance(x.dtype) * (1 + |plain|)`` plus twice
    ``f32_rounding_bound`` (at N = 128 two f32 summation orders differ by
    more than 1e-4 on a few elements where sums cancel).

    Returns ``((y, y_allowed), (state, state_allowed))``, all f64."""
    y, state = ssd_reference(x, da, b_mat, c_mat, chunk)
    y_b, st_b = f32_rounding_bound(x, da, b_mat, c_mat, chunk)
    tol = tolerance(x.dtype)
    y, state = y.double(), state.double()
    return ((y, tol + tol * y.abs() + 2 * y_b),
            (state, tol + tol * state.abs() + 2 * st_b))

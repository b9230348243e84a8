"""Mamba-2 (SSD — state-space duality) mixer layer. [arXiv:2405.21060]

The port of ``repro.models.mamba2``: the chunked SSD (``segsum`` and
``ssd_reference``, whose plain torch form lives beside the CUDA kernel in
``kernels/ssd_scan/ref.py``), the single-token recurrent decode step, and
the mixer.  Single B/C group (ngroups=1), scalar-per-head A — the Mamba-2
defaults.

Layer structure (Mamba-2 block):
    in_proj -> [z | x | B | C | dt]
    causal depthwise conv + silu over (x, B, C)
    y = SSD(x * dt, dt*A, B, C) + D * x
    out = out_proj( rmsnorm(y * silu(z)) )

With ``use_kernel`` the full-sequence SSD (the prefill's and the training
forward's) goes through ``kernels.ssd_scan.ops`` (the CUDA kernel for
CUDA tensors; its gradient through the plain version); without it through
the plain ``ssd_reference``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import segsum, ssd_reference
from repro_torch.models.layers import Params, dense_init, draw_generator, \
    init_rms_norm, rms_norm

__all__ = ["segsum", "ssd_reference", "ssd_recurrent_step", "init_mamba",
           "mamba_mixer", "mamba_mixer_with_state", "init_mamba_cache",
           "mamba_decode"]


def ssd_recurrent_step(state: torch.Tensor, x_t: torch.Tensor,
                       da_t: torch.Tensor, b_t: torch.Tensor,
                       c_t: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSD recurrence.

    state: [B, H, P, N]; x_t: [B, H, P] (pre-scaled by dt);
    da_t: [B, H]; b_t, c_t: [B, N].
    Returns (y_t [B, H, P] in x_t's dtype, new_state).
    """
    decay = torch.exp(da_t.float())[..., None, None]             # [B,H,1,1]
    outer = x_t.float()[..., None] * b_t.float()[:, None, None, :]
    new_state = state * decay + outer
    y = torch.einsum("bhpn,bn->bhp", new_state, c_t.float())
    return y.to(x_t.dtype), new_state


# ---------------------------------------------------------------------------
# Mamba-2 mixer layer
# ---------------------------------------------------------------------------


def init_mamba(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d = cfg.d_model
    mc = cfg.mamba
    di = mc.d_inner(d)
    nh = mc.n_heads(d)
    n = mc.d_state
    conv_ch = di + 2 * n
    dev = gen.device
    in_proj = dense_init(gen, (d, 2 * di + 2 * n + nh), in_axis_size=d)
    conv_w = dense_init(gen, (mc.d_conv, conv_ch), in_axis_size=mc.d_conv)
    # dt bias: softplus^-1 of dt log-uniform in [1e-3, 1e-1]
    u = torch.rand(nh, generator=draw_generator(gen), dtype=torch.float32,
                   device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    out_proj = dense_init(gen, (di, d), in_axis_size=di)
    return {
        "norm": init_rms_norm(d, dev),
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros(conv_ch, dtype=torch.float32, device=dev),
        "A_log": torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                        device=dev)),
        "D": torch.ones(nh, dtype=torch.float32, device=dev),
        "dt_bias": dt_bias,
        "gate_norm": init_rms_norm(di, dev),
        "out_proj": out_proj,
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    d = cfg.d_model
    mc = cfg.mamba
    di = mc.d_inner(d)
    n = mc.d_state
    nh = mc.n_heads(d)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: 2 * di + 2 * n]
    dt = zxbcdt[..., 2 * di + 2 * n:]
    return z, xbc, dt, di, n, nh


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over sequence + silu. xbc: [B, S, C];
    w: [K, C]."""
    k = w.shape[0]
    s = xbc.shape[1]
    xp = F.pad(xbc, (0, 0, k - 1, 0))                # [B, S+K-1, C]
    w = w.to(xbc.dtype)
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i: i + s] * w[i]
    return F.silu(out + b.to(xbc.dtype))


def mamba_mixer(params: Params, cfg: ModelConfig, x: torch.Tensor,
                use_kernel: bool = False) -> torch.Tensor:
    """Full-sequence Mamba-2 mixer (train / prefill). x: [B, S, d]."""
    y, _ = mamba_mixer_with_state(params, cfg, x, use_kernel=use_kernel)
    return y


def mamba_mixer_with_state(params: Params, cfg: ModelConfig, x: torch.Tensor,
                           use_kernel: bool = False
                           ) -> Tuple[torch.Tensor, Params]:
    """Mixer that also returns the decode cache (final SSM + conv state)."""
    dtype = x.dtype
    mc = cfg.mamba
    zxbcdt = x @ params["in_proj"].to(dtype)
    z, xbc_raw, dt, di, n, nh = _split_proj(cfg, zxbcdt)
    # conv cache: the last (d_conv - 1) *raw* channel inputs
    k1 = mc.d_conv - 1
    if xbc_raw.shape[1] >= k1:
        conv_tail = xbc_raw[:, xbc_raw.shape[1] - k1:]
    else:
        conv_tail = F.pad(xbc_raw, (0, 0, k1 - xbc_raw.shape[1], 0))
    xbc = _causal_conv(xbc_raw, params["conv_w"], params["conv_b"])
    xs = xbc[..., :di]
    b_mat = xbc[..., di: di + n]
    c_mat = xbc[..., di + n:]
    dt = F.softplus(dt.float() + params["dt_bias"])              # [B,S,H]
    a = -torch.exp(params["A_log"])                              # [H]
    xh = xs.reshape(*xs.shape[:2], nh, mc.head_dim)              # [B,S,H,P]
    x_scaled = xh * dt[..., None].to(dtype)
    da = dt * a                                                  # [B,S,H]
    s = x.shape[1]
    chunk = min(mc.chunk_size, s)
    if s % chunk:  # pad to a chunk multiple (padded steps: decay 1, x 0)
        pad = chunk - s % chunk
        x_scaled = F.pad(x_scaled, (0, 0, 0, 0, 0, pad))
        da = F.pad(da, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
    if use_kernel:
        y, final_state = ssd_ops.ssd(x_scaled.contiguous(), da.contiguous(),
                                     b_mat.contiguous(), c_mat.contiguous(),
                                     chunk)
    else:
        y, final_state = ssd_reference(x_scaled, da, b_mat, c_mat, chunk)
    y = y[:, :s]
    y = y + xh * params["D"].to(dtype)[None, None, :, None]
    y = y.reshape(*x.shape[:2], di)
    y = rms_norm(params["gate_norm"], y * F.silu(z), cfg.norm_eps)
    out = y @ params["out_proj"].to(dtype)
    return out, {"conv": conv_tail, "ssm": final_state}


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: torch.device) -> Params:
    d = cfg.d_model
    mc = cfg.mamba
    di = mc.d_inner(d)
    n = mc.d_state
    nh = mc.n_heads(d)
    return {
        "conv": torch.zeros(batch, mc.d_conv - 1, di + 2 * n, dtype=dtype,
                            device=device),
        "ssm": torch.zeros(batch, nh, mc.head_dim, n, dtype=torch.float32,
                           device=device),
    }


def mamba_decode(params: Params, cfg: ModelConfig, x: torch.Tensor,
                 cache: Params) -> Tuple[torch.Tensor, Params]:
    """One-token recurrent step. x: [B, 1, d]."""
    dtype = x.dtype
    mc = cfg.mamba
    zxbcdt = x @ params["in_proj"].to(dtype)
    z, xbc, dt, di, n, nh = _split_proj(cfg, zxbcdt)
    # conv over (cached window + new token)
    conv_in = torch.cat([cache["conv"].to(dtype), xbc], dim=1)
    w = params["conv_w"].to(dtype)
    out = conv_in[:, 0:1] * w[0]
    for i in range(1, mc.d_conv):
        out = out + conv_in[:, i: i + 1] * w[i]
    xbc_t = F.silu(out + params["conv_b"].to(dtype))             # [B,1,C]
    new_conv = conv_in[:, 1:]
    xs = xbc_t[..., :di]
    b_t = xbc_t[:, 0, di: di + n]
    c_t = xbc_t[:, 0, di + n:]
    dt_t = F.softplus(dt[:, 0].float() + params["dt_bias"])      # [B,H]
    a = -torch.exp(params["A_log"])
    xh = xs[:, 0].reshape(-1, nh, mc.head_dim)                   # [B,H,P]
    y_t, new_ssm = ssd_recurrent_step(
        cache["ssm"], xh * dt_t[..., None].to(dtype), dt_t * a, b_t, c_t)
    y_t = y_t + xh * params["D"].to(dtype)[None, :, None]
    y = y_t.reshape(-1, 1, di)
    y = rms_norm(params["gate_norm"], y * F.silu(z), cfg.norm_eps)
    y = y @ params["out_proj"].to(dtype)
    return y, {"conv": new_conv, "ssm": new_ssm}

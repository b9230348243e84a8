"""Core layers of the LM stack: initialisers, RMSNorm, RoPE, GQA
attention and the gated MLP (port of ``repro.models.layers``).

Pure functions over plain dict trees, as in the reference, with its
layouts at every public function (q ``[B, S, H, D]``, k and v ``[B, S,
KV, D]``).  Initialisers draw from an explicit ``torch.Generator`` on the
generator's device and return f32 tensors there: the values differ from
``jax.random``'s, the distributions do not.

Full-sequence attention has three paths, as in the reference:

  * ``naive``   -- full [S, T] logits;
  * ``blocked`` -- a loop over query chunks, each against every key;
  * ``kernel``  -- ``kernels.flash_attention`` (the reference's
    ``pallas``): the hand-written CUDA kernel for CUDA tensors, its plain
    version on the CPU.

Attention against a KV cache (prefill that fills it, one-token decode,
the ring forms) comes with the attention-serving slice.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels.flash_attention import ops as fa_ops

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


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str = "cpu") -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions broadcastable to [..., S].  Split-half
    rotation with f32 angles, cast back to x's dtype."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # [D/2]
    angles = positions[..., None].float() * freqs             # [..., S, D/2]
    angles = angles[..., None, :]                             # [..., S, 1, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    dev = gen.device
    p = {
        "norm": init_rms_norm(d, dev),
        "wq": dense_init(gen, (d, h, hd), in_axis_size=d),
        "wk": dense_init(gen, (d, kv, hd), in_axis_size=d),
        "wv": dense_init(gen, (d, kv, hd), in_axis_size=d),
        "wo": dense_init(gen, (h, hd, d), in_axis_size=h * hd),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", h), ("bk", kv), ("bv", kv)):
            p[name] = torch.zeros(n, hd, dtype=torch.float32, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = init_rms_norm(hd, dev)
        p["k_norm"] = init_rms_norm(hd, dev)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` as one matmul, in x's dtype."""
    out = x @ w.to(x.dtype).reshape(w.shape[0], -1)
    return out.reshape(*x.shape[:-1], *w.shape[1:])


def _qkv(params: Params, cfg: ModelConfig, x: torch.Tensor,
         positions: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dtype = x.dtype
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"].to(dtype)
        k = k + params["bk"].to(dtype)
        v = v + params["bv"].to(dtype)
    if cfg.qk_norm:
        q = rms_norm(params["q_norm"], q, cfg.norm_eps)
        k = rms_norm(params["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor,
               window: int) -> torch.Tensor:
    """Additive mask [Sq, Sk]: causal (+ sliding window if window>0)."""
    ok = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        ok &= k_pos[None, :] > (q_pos[:, None] - window)
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, -1e30)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          bias: torch.Tensor, scale: float) -> torch.Tensor:
    """Grouped scaled-dot-product attention.

    q: [B, Sq, H, D]; k, v: [B, Sk, KV, D]; bias: [Sq, Sk] additive.
    """
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    logits = logits * scale + bias
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, sq, h, d)


def _blocked_attention(q, k, v, q_positions, k_positions, window, scale,
                       block_q=1024):
    """Query chunks of ``block_q`` rows, each against every key (the
    reference's ``lax.scan`` over chunks as a Python loop; its
    ``window_slice`` option is not ported)."""
    b, s, h, d = q.shape
    nblocks = -(-s // block_q)
    pad = nblocks * block_q - s
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        q_positions = F.pad(q_positions, (0, pad), value=-1)
    outs = []
    for i in range(nblocks):
        rows = slice(i * block_q, (i + 1) * block_q)
        bias = _mask_bias(q_positions[rows], k_positions, window)
        outs.append(_sdpa(q[:, rows], k, v, bias, scale))
    return torch.cat(outs, dim=1)[:, :s]


def attention(params: Params, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Full-sequence causal attention (train / scoring).  ``impl``:
    ``kernel``, ``naive``, ``blocked`` or ``auto`` (the reference's rule:
    naive up to 2048 positions, blocked beyond)."""
    q, k, v = _qkv(params, cfg, x, positions)
    scale = cfg.resolved_head_dim ** -0.5
    s = x.shape[1]
    if impl == "auto":
        impl = "naive" if s <= 2048 else "blocked"
    if impl == "kernel":
        out = fa_ops.flash_attention(q, k, v, causal=True,
                                     window=cfg.sliding_window)
    elif impl == "blocked":
        out = _blocked_attention(q, k, v, positions, positions,
                                 cfg.sliding_window, scale)
    elif impl == "naive":
        bias = _mask_bias(positions, positions, cfg.sliding_window)
        out = _sdpa(q, k, v, bias, scale)
    else:
        raise ValueError(f"unknown attention impl {impl!r}; expected "
                         "kernel, naive, blocked or auto")
    return _proj(out.reshape(*out.shape[:2], -1),
                 params["wo"].reshape(-1, params["wo"].shape[-1]))


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d: int, f: int) -> Params:
    return {
        "norm": init_rms_norm(d, gen.device),
        "wi_gate": dense_init(gen, (d, f)),
        "wi_up": dense_init(gen, (d, f)),
        "wo": dense_init(gen, (f, d)),
    }


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def mlp(params: Params, x: torch.Tensor, act_fn: str = "silu"
        ) -> torch.Tensor:
    dtype = x.dtype
    gate = _act(act_fn, x @ params["wi_gate"].to(dtype))
    up = x @ params["wi_up"].to(dtype)
    return (gate * up) @ params["wo"].to(dtype)

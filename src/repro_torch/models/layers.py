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

Attention against a KV cache, as in the reference: ``attention_fill``
(prefill: writes K/V for positions [0, S) and returns ``attention``'s
output), ``attention_decode`` (one token against ``[B, S_max, KV, D]`` at
a scalar index, masked over S_max and by the window) and their ring forms
for sliding-window models (``attention_fill_ring``,
``attention_decode_ring``: position p lives in slot p mod L).  The fills
take the full-sequence paths above; with ``impl="kernel"`` they run the
``flash_attention`` kernel on a CUDA tensor, where the reference always
fills with naive or blocked attention (the kernel fill is held to the
naive one).  The caches are written in place and returned, and the decode
index stays a device tensor: a step reads nothing back to the host.

``window_slice``, as in the reference: with a sliding window, each query
block of the blocked path reads only the ``window + block_q`` keys that
can reach it, and the decode reads only the ``window + 1`` cache rows
that end at the new token (gathered at a start computed on the device),
in place of masking the whole cache.  The values are the masked path's;
the naive and kernel paths ignore the option (the kernel already skips
the tiles outside the window).
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


def draw_generator(gen: torch.Generator) -> torch.Generator | None:
    """The generator an init draws from, or None for a shape-only tree:
    ``gen`` on the ``meta`` device stands for no generator (a ``meta``
    model's ``LM.init(None)``), and its leaves hold no values."""
    return None if gen.device.type == "meta" else gen


def dense_init(gen: torch.Generator, shape: Sequence[int],
               in_axis_size: int | None = None) -> torch.Tensor:
    """Truncated-normal fan-in init (1/sqrt(fan_in), cut at 2 sigma)."""
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    t = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                generator=draw_generator(gen))
    return t.mul_(std)


def embed_init(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=draw_generator(gen),
                       dtype=torch.float32, device=gen.device) * 0.02


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
                       block_q=1024, window_slice=False):
    """Query chunks of ``block_q`` rows (the reference's ``lax.scan`` over
    chunks as a Python loop), each against every key, or with
    ``window_slice`` and a window against the ``window + block_q`` keys
    ending at the chunk's last row (O(S * window) work)."""
    b, s, h, d = q.shape
    t = k.shape[1]
    nblocks = -(-s // block_q)
    pad = nblocks * block_q - s
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        q_positions = F.pad(q_positions, (0, pad), value=-1)
    span = min(window + block_q, t) if window_slice and window > 0 else t
    outs = []
    for i in range(nblocks):
        rows = slice(i * block_q, (i + 1) * block_q)
        start = min(max((i + 1) * block_q - span, 0), t - span)
        keys = slice(start, start + span)
        bias = _mask_bias(q_positions[rows], k_positions[keys], window)
        outs.append(_sdpa(q[:, rows], k[:, keys], v[:, keys], bias, scale))
    return torch.cat(outs, dim=1)[:, :s]


def _full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    cfg: ModelConfig, positions: torch.Tensor,
                    impl: str, window_slice: bool = False) -> torch.Tensor:
    """Causal (optionally windowed) attention of the whole sequence by
    ``impl``: ``kernel``, ``naive``, ``blocked`` or ``auto`` (the
    reference's rule: naive up to 2048 positions, blocked beyond);
    ``window_slice`` reaches the blocked path only, as there."""
    scale = cfg.resolved_head_dim ** -0.5
    if impl == "auto":
        impl = "naive" if q.shape[1] <= 2048 else "blocked"
    if impl == "kernel":
        return fa_ops.flash_attention(q, k, v, causal=True,
                                      window=cfg.sliding_window)
    if impl == "blocked":
        return _blocked_attention(q, k, v, positions, positions,
                                  cfg.sliding_window, scale,
                                  window_slice=window_slice)
    if impl == "naive":
        bias = _mask_bias(positions, positions, cfg.sliding_window)
        return _sdpa(q, k, v, bias, scale)
    raise ValueError(f"unknown attention impl {impl!r}; expected kernel, "
                     "naive, blocked or auto")


def _out_proj(params: Params, out: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd", out, wo)`` in out's dtype."""
    return _proj(out.reshape(*out.shape[:2], -1),
                 params["wo"].reshape(-1, params["wo"].shape[-1]))


def attention(params: Params, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, impl: str = "auto",
              window_slice: bool = False) -> torch.Tensor:
    """Full-sequence causal attention (train / scoring).  ``impl``:
    ``kernel``, ``naive``, ``blocked`` or ``auto`` (the reference's rule:
    naive up to 2048 positions, blocked beyond)."""
    q, k, v = _qkv(params, cfg, x, positions)
    return _out_proj(params, _full_attention(q, k, v, cfg, positions, impl,
                                             window_slice))


def attention_fill(params: Params, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor, cache_k: torch.Tensor,
                   cache_v: torch.Tensor, impl: str = "auto",
                   window_slice: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence attention that also fills the KV cache (prefill).

    Writes K/V for positions [0, S) into ``cache_k`` / ``cache_v`` [B,
    S_max, KV, D] in place and returns ``attention``'s output with them.
    """
    q, k, v = _qkv(params, cfg, x, positions)
    s = x.shape[1]
    cache_k[:, :s].copy_(k)
    cache_v[:, :s].copy_(v)
    y = _out_proj(params, _full_attention(q, k, v, cfg, positions, impl,
                                          window_slice))
    return y, cache_k, cache_v


def attention_fill_ring(params: Params, cfg: ModelConfig, x: torch.Tensor,
                        positions: torch.Tensor, cache_k: torch.Tensor,
                        cache_v: torch.Tensor, impl: str = "auto",
                        window_slice: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill that fills a ring cache of length L in place: only the
    last ``min(S, L)`` positions land in it, at slot = position mod L."""
    q, k, v = _qkv(params, cfg, x, positions)
    s, ring = x.shape[1], cache_k.shape[1]
    n = min(s, ring)
    slots = torch.arange(s - n, s, device=x.device) % ring
    cache_k.index_copy_(1, slots, k[:, s - n:].to(cache_k.dtype))
    cache_v.index_copy_(1, slots, v[:, s - n:].to(cache_v.dtype))
    y = _out_proj(params, _full_attention(q, k, v, cfg, positions, impl,
                                          window_slice))
    return y, cache_k, cache_v


def _decode_qkv(params: Params, cfg: ModelConfig, x: torch.Tensor,
                cache_index: torch.Tensor):
    """q, k, v of one new token per row at position ``cache_index``."""
    positions = cache_index.reshape(1, 1).expand(x.shape[0], 1)
    return _qkv(params, cfg, x, positions)


def _decode_attend(params: Params, cfg: ModelConfig, q: torch.Tensor,
                   cache_k: torch.Tensor, cache_v: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=torch.float32, device=valid.device)
    bias = torch.where(valid, zero, -1e30)[None, :]
    out = _sdpa(q, cache_k.to(q.dtype), cache_v.to(q.dtype), bias,
                cfg.resolved_head_dim ** -0.5)
    return _out_proj(params, out)


def attend_partial(q: torch.Tensor, cache_k: torch.Tensor,
                   cache_v: torch.Tensor, valid: torch.Tensor, scale: float
                   ) -> torch.Tensor:
    """One rank's share of split-KV decode attention over its block of
    keys: per query head the f32 (max, sum, Σ p·V) of its valid keys,
    packed as ``[B, KV, G, Sq, D + 2]`` (Σ p·V, then the max, then the
    sum).  A block with no valid key gives max -inf and exact zeros."""
    b, sq, h, d = q.shape
    kvh = cache_k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, d)
    s = torch.einsum("bskgd,btkd->bkgst", qg,
                     cache_k.to(q.dtype)).float() * scale
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
    o = torch.einsum("bkgst,btkd->bkgsd", p, cache_v.float())
    return torch.cat([o, m, p.sum(-1, keepdim=True)], dim=-1)


def combine_split_attention(parts: torch.Tensor) -> torch.Tensor:
    """The ranks' :func:`attend_partial` shares ``[R, B, KV, G, Sq, D +
    2]`` combined in rank order: ``Σ_r e^(m_r - M) o_r / Σ_r e^(m_r - M)
    l_r`` with M the ranks' max, so a share with no valid key adds exact
    zeros.  Returns ``[B, Sq, H, D]`` (f32)."""
    o, m, l_ = parts[..., :-2], parts[..., -2:-1], parts[..., -1:]
    w = torch.exp(m - m.amax(0))
    num, den = w[0] * o[0], w[0] * l_[0]
    for r in range(1, parts.shape[0]):
        num = num + w[r] * o[r]
        den = den + w[r] * l_[r]
    out = num / den                                     # [B, KV, G, Sq, D]
    b, kvh, g, sq, d = out.shape
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, kvh * g, d)


def attention_decode_split(params: Params, cfg: ModelConfig,
                           x: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor, cache_index: torch.Tensor,
                           split) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """:func:`attention_decode` against a K/V cache whose sequence is split
    over a group of ranks (``split``: ``repro_torch.train.layout.KVSplit``,
    this rank's positions ``lo .. lo + n - 1``; ``cache_k`` / ``cache_v``
    its block ``[B, n, KV, D]``).  Every rank forms the new token's q, k,
    v; only the rank that owns slot ``cache_index`` (clamped to the last
    slot, as the unsplit write is) writes its K/V; each rank's f32 (max,
    sum, Σ p·V) over its block (:func:`attend_partial`, the causal and
    window mask at its positions) is all-gathered over the group and
    combined in rank order (:func:`combine_split_attention`)."""
    from repro_torch.launch.mesh import gather_edge_stack, group_size
    n = cache_k.shape[1]
    s_max = n * group_size(split.group)
    win = cfg.sliding_window
    q, k_new, v_new = _decode_qkv(params, cfg, x, cache_index)
    rel = cache_index.clamp(0, s_max - 1) - split.lo
    owner = (rel >= 0) & (rel < n)
    slot = rel.clamp(0, n - 1).reshape(1).long()
    for cache, new in ((cache_k, k_new), (cache_v, v_new)):
        cache.index_copy_(1, slot, torch.where(
            owner, new.to(cache.dtype), cache.index_select(1, slot)))
    k_pos = split.lo + torch.arange(n, device=x.device)
    valid = k_pos <= cache_index
    if win > 0:
        valid &= k_pos > (cache_index - win)
    part = attend_partial(q, cache_k, cache_v, valid,
                          cfg.resolved_head_dim ** -0.5)
    parts = gather_edge_stack(part.reshape(1, -1), split.group)
    out = combine_split_attention(parts.view((-1,) + part.shape))
    return _out_proj(params, out.to(q.dtype)), cache_k, cache_v


def attention_decode(params: Params, cfg: ModelConfig, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     cache_index: torch.Tensor, window_slice: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against a KV cache.

    x: [B, 1, d]; cache_k/v: [B, S_max, KV, D], written in place;
    cache_index: 0-d int tensor (current length, the new token's
    position), on the device: the write and the mask index with it, and
    nothing is read back to the host.  As the reference's
    ``dynamic_update_slice``, a write past S_max lands in the last slot.
    ``window_slice`` with a window shorter than S_max: attend over only
    the ``window + 1`` rows that end at the new token, gathered from a
    start clamped on the device (the reference's ``dynamic_slice``).
    Returns (y [B, 1, d], cache_k, cache_v).
    """
    s_max = cache_k.shape[1]
    win = cfg.sliding_window
    q, k_new, v_new = _decode_qkv(params, cfg, x, cache_index)
    slot = cache_index.clamp(0, s_max - 1).reshape(1).long()
    cache_k.index_copy_(1, slot, k_new.to(cache_k.dtype))
    cache_v.index_copy_(1, slot, v_new.to(cache_v.dtype))
    if window_slice and 0 < win < s_max:
        span = win + 1                     # the window ending at the token
        start = (cache_index - win).clamp(0, s_max - span)
        k_pos = start + torch.arange(span, device=x.device)
        k_r = cache_k.index_select(1, k_pos)
        v_r = cache_v.index_select(1, k_pos)
    else:
        k_r, v_r = cache_k, cache_v
        k_pos = torch.arange(s_max, device=x.device)
    valid = k_pos <= cache_index
    if win > 0:
        valid &= k_pos > (cache_index - win)
    return _decode_attend(params, cfg, q, k_r, v_r, valid), \
        cache_k, cache_v


def attention_decode_ring(params: Params, cfg: ModelConfig, x: torch.Tensor,
                          cache_k: torch.Tensor, cache_v: torch.Tensor,
                          cache_index: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against a ring (rolling) KV cache of length L,
    written in place at slot ``index mod L``.  Slot j holds absolute
    position ``index - ((index - j) mod L)``; keys are stored after RoPE,
    so only the mask needs the positions, and the fresh token is always
    live."""
    ring = cache_k.shape[1]
    q, k_new, v_new = _decode_qkv(params, cfg, x, cache_index)
    slot = cache_index.remainder(ring).reshape(1).long()
    cache_k.index_copy_(1, slot, k_new.to(cache_k.dtype))
    cache_v.index_copy_(1, slot, v_new.to(cache_v.dtype))
    j = torch.arange(ring, device=x.device)
    k_pos = cache_index - (cache_index - j).remainder(ring)
    valid = k_pos >= 0
    if cfg.sliding_window > 0:
        valid &= k_pos > (cache_index - cfg.sliding_window)
    valid |= j == slot                  # the fresh token is always live
    return _decode_attend(params, cfg, q, cache_k, cache_v, valid), \
        cache_k, cache_v


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

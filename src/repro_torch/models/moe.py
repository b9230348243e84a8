"""Mixture-of-Experts FFN with token-choice top-k routing (port of
``repro.models.moe``).

Sort-free capacity dispatch, as in the reference:

  1. router logits -> softmax -> top-k experts per token (renormalized),
     in f32, ties to the lower expert index as ``lax.top_k`` breaks them;
  2. position-in-expert by an exclusive cumsum of expert one-hots
     (``dispatch="cumsum"``) or by a stable argsort by expert id
     (``"sort"``: the same positions in O(T*k) memory);
  3. tokens copied into an ``[E*C + 1, d]`` buffer (dropped assignments
     fall into the sentinel row, which is discarded), the expert SwiGLU
     as batched matmuls over ``[E, C, ...]``;
  4. gather back and a gate-weighted combine; optional shared experts
     (dense, DeepSeekMoE).

The reference's combine is a scatter-add ``.at[flat_tok].add``; here
token t's k contributions are rows ``t*k .. t*k+k-1`` of the gathered
buffer, so the combine is ``view(T, k, d).sum(1)``: a fixed summation
order, where ``index_add_``'s atomics on a card would make the sum (and
greedy tokens) vary from run to run.

Aux losses follow the standard load-balance formulation
``E * sum_e f_e * P_e`` plus a router z-loss.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.layers import Params, _act, dense_init, \
    init_rms_norm

AUX_KEYS = ("load_balance_loss", "router_z_loss", "expert_frac_max")


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> Params:
    m = cfg.moe
    d = cfg.d_model
    p = {
        "norm": init_rms_norm(d, gen.device),
        "router": dense_init(gen, (d, m.num_experts)),
        "we_gate": dense_init(gen, (m.num_experts, d, m.expert_ffn_dim),
                              in_axis_size=d),
        "we_up": dense_init(gen, (m.num_experts, d, m.expert_ffn_dim),
                            in_axis_size=d),
        "we_down": dense_init(gen, (m.num_experts, m.expert_ffn_dim, d),
                              in_axis_size=m.expert_ffn_dim),
    }
    if m.num_shared_experts > 0:
        p["ws_gate"] = dense_init(gen, (d, m.shared_ffn_dim))
        p["ws_up"] = dense_init(gen, (d, m.shared_ffn_dim))
        p["ws_down"] = dense_init(gen, (m.shared_ffn_dim, d))
    return p


def capacity(num_tokens: int, cfg: ModelConfig) -> int:
    """Per-expert dispatch capacity.

    Large token counts use the standard ``T*k/E * capacity_factor``
    dropping rule; small counts (decode steps, tiny smoke batches) get the
    worst-case ``T*k`` so decode is DROPLESS — otherwise a one-token step
    could silently drop its own expert contribution and decode would not
    match the full forward pass.
    """
    m = cfg.moe
    c = int(num_tokens * m.top_k / m.num_experts * m.capacity_factor)
    if num_tokens * m.top_k <= 4096:
        return max(c, num_tokens * m.top_k)
    return max(c, m.top_k)


def route(router: torch.Tensor, xf: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 routing of tokens ``xf`` [T, d]: (logits [T, E], probs [T, E],
    gate [T, k] renormalized, expert_idx [T, k]).  The top k by a stable
    descending sort: equal probabilities keep the lower expert index
    first, as ``lax.top_k`` orders them (``torch.topk`` does not promise
    an order among ties)."""
    logits = xf.float() @ router.float()                        # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert_idx = top[:, :k], order[:, :k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return logits, probs, gate, expert_idx


def moe_ffn(params: Params, cfg: ModelConfig, x: torch.Tensor
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, S, d] -> (y [B, S, d], aux {load_balance_loss,
    router_z_loss, expert_frac_max})."""
    m = cfg.moe
    b, s, d = x.shape
    if m.dispatch_groups > 1 and (b * s) % m.dispatch_groups == 0:
        # grouped dispatch: tokens are routed within ``dispatch_groups``
        # independent groups (the reference vmaps over them), each with
        # its own capacity; aux is the groups' max for expert_frac_max
        # and their mean otherwise
        g = m.dispatch_groups
        xg = x.reshape(g, (b * s) // g, 1, d)
        outs = [_moe_ffn_flat(params, cfg, xe) for xe in xg.unbind(0)]
        y = torch.stack([o[0] for o in outs])
        aux = {}
        for key in AUX_KEYS:
            v = torch.stack([o[1][key] for o in outs])
            aux[key] = v.max() if key == "expert_frac_max" else v.mean()
        return y.reshape(b, s, d), aux
    return _moe_ffn_flat(params, cfg, x)


def _moe_ffn_flat(params: Params, cfg: ModelConfig, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    k = m.top_k
    e = m.num_experts
    cap = capacity(t, cfg)
    dtype, dev = x.dtype, x.device
    xf = x.reshape(t, d)

    # ---- routing (f32) ---------------------------------------------------
    logits, probs, gate, expert_idx = route(params["router"], xf, k)

    # ---- aux losses -------------------------------------------------------
    flat_e = expert_idx.reshape(t * k)                            # [T*k]
    # bincount as a scatter of ones (exact in any order; its output
    # shape, unlike bincount's, does not depend on the data)
    counts = torch.zeros(e, dtype=torch.long, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e)).float()               # [E]
    frac_routed = counts / (t * k)                                # f_e
    mean_prob = probs.mean(dim=0)                                 # P_e
    aux = {
        "load_balance_loss": e * (frac_routed * mean_prob).sum(),
        "router_z_loss": torch.logsumexp(logits, dim=-1).square().mean(),
        "expert_frac_max": frac_routed.max(),
    }

    # ---- position-in-expert ------------------------------------------------
    flat_gate = gate.reshape(t * k).to(dtype)
    flat_tok = torch.arange(t, device=dev).repeat_interleave(k)   # [T*k]
    if m.dispatch == "sort":
        # a stable argsort by expert id gives each assignment's rank
        # within its expert; stable order keeps tokens in order within an
        # expert, so keep/drop decisions are the cumsum path's
        sort_idx = torch.sort(flat_e, stable=True).indices        # [T*k]
        counts_i = counts.long()
        starts = torch.cumsum(counts_i, 0) - counts_i             # [E]
        pos_sorted = torch.arange(t * k, device=dev) - starts[flat_e[sort_idx]]
        pos_in_e = torch.zeros(t * k, dtype=torch.long, device=dev) \
            .index_put((sort_idx,), pos_sorted)
    else:
        # exclusive running count per expert
        oh = torch.nn.functional.one_hot(flat_e, e)               # [T*k, E]
        pos = torch.cumsum(oh, dim=0) - oh                        # exclusive
        pos_in_e = (pos * oh).sum(-1)                             # [T*k]
    keep = pos_in_e < cap
    # dropped assignments go to the sentinel row E*cap
    dst = torch.where(keep, flat_e * cap + pos_in_e,
                      torch.full_like(pos_in_e, e * cap))

    # ---- dispatch (only the sentinel row receives duplicates) --------------
    buf = torch.zeros(e * cap + 1, d, dtype=dtype, device=dev)
    buf = buf.index_copy(0, dst, xf[flat_tok])
    xb = buf[: e * cap].reshape(e, cap, d)                        # [E, C, d]

    # ---- expert FFN ---------------------------------------------------------
    g = _act(cfg.act_fn, torch.bmm(xb, params["we_gate"].to(dtype)))
    u = torch.bmm(xb, params["we_up"].to(dtype))
    yb = torch.bmm(g * u, params["we_down"].to(dtype))            # [E, C, d]

    # ---- combine: token t's k contributions are rows t*k .. t*k+k-1 ---------
    ybuf = torch.cat([yb.reshape(e * cap, d),
                      torch.zeros(1, d, dtype=dtype, device=dev)])
    contrib = ybuf[dst] * (flat_gate * keep.to(dtype))[:, None]
    y = contrib.view(t, k, d).sum(1)

    # ---- shared experts (dense path, DeepSeekMoE) ---------------------------
    if m.num_shared_experts > 0:
        sg = _act(cfg.act_fn, xf @ params["ws_gate"].to(dtype))
        su = xf @ params["ws_up"].to(dtype)
        y = y + (sg * su) @ params["ws_down"].to(dtype)

    return y.reshape(b, s, d), aux

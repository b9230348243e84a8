"""Mixture-of-Experts FFN with token-choice top-k routing (port of
``repro.models.moe``).

Sort-free capacity dispatch, as in the reference:

  1. router logits -> softmax -> top-k experts per token (renormalized),
     in f32, ties to the lower expert index as ``lax.top_k`` breaks them,
     probabilities below f32's normal range flushed to 0 as the
     reference's backends (XLA's CPU, the TPU) flush them;
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

Over ranks (``group``: the edge group a step's batch rows split over,
``repro_torch.train.layout``) a rank routes only its own tokens, yet the
dispatch is the one step's: the capacity comes from the global token
count, each expert's positions start after the earlier ranks' (an
exclusive prefix, in rank order, of the ``[E]`` counts gathered over the
group), and the aux values are formed from gathered sums, the rank's own
share carrying the gradient and the other ranks' detached.  Grouped
dispatch whose groups tile the ranks is rank-local as it stands.
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
    an order among ties); a subnormal probability is 0, as the
    reference's backends flush it (so it ties by index there too)."""
    logits = xf.float() @ router.float()                        # [T, E]
    probs = torch.softmax(logits, dim=-1)
    probs = probs.masked_fill(probs < torch.finfo(probs.dtype).tiny, 0.0)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert_idx = top[:, :k], order[:, :k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return logits, probs, gate, expert_idx


def _gathered(v: torch.Tensor, group) -> torch.Tensor:
    """``[R, n]``: every rank's ``[n]`` ``v`` (detached), rank order."""
    from repro_torch.launch.mesh import gather_edge_stack
    return gather_edge_stack(v.detach()[None], group)


def _own(own: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """The value ``total``, the gradient of ``own`` (this rank's share)."""
    return own + (total - own).detach()


def moe_ffn(params: Params, cfg: ModelConfig, x: torch.Tensor,
            group=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, S, d] -> (y [B, S, d], aux {load_balance_loss,
    router_z_loss, expert_frac_max}); ``group``: the ranks this step's
    rows split over (x the rank's rows), or ``None``."""
    m = cfg.moe
    b, s, d = x.shape
    world = 1
    if group is not None:
        from repro_torch.launch.mesh import group_size
        world = group_size(group)
    if m.dispatch_groups > 1 and (b * s * world) % m.dispatch_groups == 0:
        # grouped dispatch: tokens are routed within ``dispatch_groups``
        # independent groups (the reference vmaps over them), each with
        # its own capacity; aux is the groups' max for expert_frac_max
        # and their mean otherwise
        if m.dispatch_groups % world:
            raise ValueError(
                f"moe.dispatch_groups={m.dispatch_groups} does not tile the "
                f"{world} ranks a step's rows split over")
        g = m.dispatch_groups // world
        xg = x.reshape(g, (b * s) // g, 1, d)
        outs = [_moe_ffn_flat(params, cfg, xe) for xe in xg.unbind(0)]
        y = torch.stack([o[0] for o in outs])
        aux = {}
        for key in AUX_KEYS:
            v = torch.stack([o[1][key] for o in outs])
            aux[key] = v.max() if key == "expert_frac_max" else v.mean()
        if world > 1:
            # every rank holds g of the step's groups: the mean over all
            # is the mean of the ranks' means
            every = _gathered(torch.stack([aux[k] for k in AUX_KEYS]),
                              group)
            for i, key in enumerate(AUX_KEYS):
                aux[key] = (every[:, i].max() if key == "expert_frac_max"
                            else _own(aux[key] / world,
                                      every[:, i].sum() / world))
        return y.reshape(b, s, d), aux
    return _moe_ffn_flat(params, cfg, x, group if world > 1 else None)


def _moe_ffn_flat(params: Params, cfg: ModelConfig, x: torch.Tensor,
                  group=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    k = m.top_k
    e = m.num_experts
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
    z_sq = torch.logsumexp(logits, dim=-1).square()
    if group is None:
        cap = capacity(t, cfg)
        frac_routed = counts / (t * k)                            # f_e
        mean_prob = probs.mean(dim=0)                             # P_e
        aux = {
            "load_balance_loss": e * (frac_routed * mean_prob).sum(),
            "router_z_loss": z_sq.mean(),
            "expert_frac_max": frac_routed.max(),
        }
        offset = None
    else:
        # the step's counts, probability and z sums over every rank's
        # tokens, and the earlier ranks' counts
        from repro_torch.launch.mesh import group_rank
        every = _gathered(torch.cat([counts, probs.sum(0), z_sq.sum()[None]]),
                          group)                                  # [R, 2E+1]
        world, me = every.shape[0], group_rank(group)
        n_tok = t * world
        cap = capacity(n_tok, cfg)
        frac_routed = every[:, :e].sum(0) / (n_tok * k)
        aux = {
            "load_balance_loss": _own(
                e * (frac_routed * probs.sum(0) / n_tok).sum(),
                e * (frac_routed * every[:, e:2 * e].sum(0) / n_tok).sum()),
            "router_z_loss": _own(z_sq.sum() / n_tok,
                                  every[:, 2 * e].sum() / n_tok),
            "expert_frac_max": frac_routed.max(),
        }
        offset = every[:me, :e].sum(0).long()                     # [E]

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
    if offset is None:
        keep = pos_in_e < cap
        rows = cap
    else:
        # kept by the step's position; a rank's buffer holds its own
        # tokens only: a token's k experts are distinct, so at most
        # min(cap, T) an expert
        keep = offset[flat_e] + pos_in_e < cap
        rows = min(cap, t)
    # dropped assignments go to the sentinel row E*rows
    dst = torch.where(keep, flat_e * rows + pos_in_e,
                      torch.full_like(pos_in_e, e * rows))

    # ---- dispatch (only the sentinel row receives duplicates) --------------
    buf = torch.zeros(e * rows + 1, d, dtype=dtype, device=dev)
    buf = buf.index_copy(0, dst, xf[flat_tok])
    xb = buf[: e * rows].reshape(e, rows, d)                      # [E, C, d]

    # ---- expert FFN ---------------------------------------------------------
    g = _act(cfg.act_fn, torch.bmm(xb, params["we_gate"].to(dtype)))
    u = torch.bmm(xb, params["we_up"].to(dtype))
    yb = torch.bmm(g * u, params["we_down"].to(dtype))            # [E, C, d]

    # ---- combine: token t's k contributions are rows t*k .. t*k+k-1 ---------
    ybuf = torch.cat([yb.reshape(e * rows, d),
                      torch.zeros(1, d, dtype=dtype, device=dev)])
    contrib = ybuf[dst] * (flat_gate * keep.to(dtype))[:, None]
    y = contrib.view(t, k, d).sum(1)

    # ---- shared experts (dense path, DeepSeekMoE) ---------------------------
    if m.num_shared_experts > 0:
        sg = _act(cfg.act_fn, xf @ params["ws_gate"].to(dtype))
        su = xf @ params["ws_up"].to(dtype)
        y = y + (sg * su) @ params["ws_down"].to(dtype)

    return y.reshape(b, s, d), aux

"""Decoder-only language model over the ModelConfig space (port of
``repro.models.transformer``).

This port runs two block kinds, each through forward, ``loss``,
``prefill`` and ``decode_step``: ``(MAMBA, NO_FFN)`` (mamba2-370m) and
``(ATTN, DENSE_FFN)`` (the dense configs: qwen3-1.7b, minicpm-2b,
qwen2.5-14b, deepseek-coder-33b), every full-sequence attention (the
forward's and the prefill's) through the ``flash_attention`` kernel on
the card.  MoE blocks come with the MoE slice and raise
``NotImplementedError`` naming it.

Parameter and cache trees have the reference's shape, so weights and
caches carry across (``repro_torch.interop``): the layer pattern splits
into ``n_groups`` repetitions of a group (a uniform pattern needs no
unstacked prefix), whose leaves are stacked on a leading ``[n_groups]``
axis (every LM config sets ``scan_layers``), and the cache holds a scalar
``index``.  Where the reference scans over the stacked groups, the port
unbinds them once (one autograd node per leaf, whose backward stacks the
groups' gradients) and loops in Python; ``cfg.remat`` checkpoints each
group as ``jax.checkpoint`` does.  An attention layer writes its K/V rows
into its group's view of the stacked cache in place, so ``prefill`` and
``decode_step`` return the cache they were given with those rows (and
the index) updated, where the reference returns a new one with the same
values; the SSM state is small and is restacked.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ATTN, DENSE_FFN, MOE_FFN, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.interop import tree_map
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models.layers import Params

_MOE = "MoE blocks come with the MoE slice"
ATTN_IMPLS = ("kernel", "naive", "blocked", "auto")


def _require_ported(kind: str, ffn: str) -> None:
    if ffn == MOE_FFN:
        raise NotImplementedError(f"block ({kind}, {ffn}): {_MOE} of the "
                                  "port")


# ---------------------------------------------------------------------------
# Layer-group decomposition
# ---------------------------------------------------------------------------


def layer_groups(cfg: ModelConfig) -> Tuple[Tuple, Tuple, int]:
    """Split block pattern into (prefix, group, n_groups).

    ``prefix`` layers are applied unstacked; the remaining layers are
    ``n_groups`` repetitions of ``group``.  Minimizes the number of
    *unrolled* layers (prefix + group size), breaking ties with the
    shortest prefix.
    """
    pattern = cfg.block_pattern()
    n = len(pattern)
    best = None
    for p in range(n + 1):
        rest = pattern[p:]
        if not rest:
            cand = (10 ** 9, p)   # all-prefix fallback: never preferred
            g = 0
        else:
            g = next(gg for gg in range(1, len(rest) + 1)
                     if len(rest) % gg == 0
                     and rest == rest[:gg] * (len(rest) // gg))
            cand = (p + g, p)
        if best is None or cand < best:
            best = cand
            best_split = (pattern[:p], rest[:g] if rest else (),
                          (len(rest) // g) if rest else 0)
    return best_split


def _stack(trees: List[Any]) -> Any:
    """Stack same-shaped trees leaf by leaf on a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _unstack(tree: Any) -> List[Any]:
    """A stacked (leading-axis) group tree as one tree per group (views)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: parts[k][g] for k in tree} for g in range(n)]
    return list(tree.unbind(0))


def _restack(new: List[Any], old: List[Any], stacked: Any) -> Any:
    """Stack the per-group trees ``new`` that blocks returned for the
    views ``old = _unstack(stacked)``.  A leaf every group returned as the
    very view it was given (written in place) keeps ``stacked`` as it is,
    with no copy."""
    if isinstance(stacked, dict):
        return {k: _restack([t[k] for t in new], [t[k] for t in old],
                            stacked[k]) for k in stacked}
    if all(n is o for n, o in zip(new, old)):
        return stacked
    return torch.stack(new)


# ---------------------------------------------------------------------------
# Single block (mixer + optional FFN)
# ---------------------------------------------------------------------------


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str,
               ffn: str) -> Params:
    _require_ported(kind, ffn)
    p: Params = {"mix": L.init_attention(gen, cfg) if kind == ATTN
                 else M.init_mamba(gen, cfg)}
    if ffn == DENSE_FFN:
        p["ffn"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff)
    return p


def _apply_ffn(p: Params, cfg: ModelConfig, ffn: str,
               x: torch.Tensor) -> torch.Tensor:
    if ffn == DENSE_FFN:
        h = L.rms_norm(p["ffn"]["norm"], x, cfg.norm_eps)
        x = x + L.mlp(p["ffn"], h, cfg.act_fn)
    return x


def apply_block(p: Params, cfg: ModelConfig, kind: str, ffn: str,
                x: torch.Tensor, positions: torch.Tensor,
                attn_impl: str = "auto", use_ssd_kernel: bool = False
                ) -> torch.Tensor:
    _require_ported(kind, ffn)
    h = L.rms_norm(p["mix"]["norm"], x, cfg.norm_eps)
    if kind == ATTN:
        x = x + L.attention(p["mix"], cfg, h, positions, impl=attn_impl)
    else:
        x = x + M.mamba_mixer(p["mix"], cfg, h, use_kernel=use_ssd_kernel)
    return _apply_ffn(p, cfg, ffn, x)


def apply_block_fill(p: Params, cfg: ModelConfig, kind: str, ffn: str,
                     x: torch.Tensor, positions: torch.Tensor,
                     cache: Params, attn_impl: str = "auto",
                     use_ssd_kernel: bool = False, ring: bool = False
                     ) -> Tuple[torch.Tensor, Params]:
    """Full-sequence block that also fills the decode cache (prefill):
    an attention layer writes its K/V into ``cache`` in place (a ring
    cache with ``ring``), an SSM layer returns its final state."""
    _require_ported(kind, ffn)
    h = L.rms_norm(p["mix"]["norm"], x, cfg.norm_eps)
    if kind == ATTN:
        fill = L.attention_fill_ring if ring else L.attention_fill
        y, ck, cv = fill(p["mix"], cfg, h, positions, cache["k"],
                         cache["v"], impl=attn_impl)
        cache = {"k": ck, "v": cv}
    else:
        y, cache = M.mamba_mixer_with_state(p["mix"], cfg, h,
                                            use_kernel=use_ssd_kernel)
    return _apply_ffn(p, cfg, ffn, x + y), cache


def apply_block_decode(p: Params, cfg: ModelConfig, kind: str, ffn: str,
                       x: torch.Tensor, cache: Params, index: torch.Tensor,
                       ring: bool = False) -> Tuple[torch.Tensor, Params]:
    """One-token block at position ``index`` (a 0-d device tensor)."""
    _require_ported(kind, ffn)
    h = L.rms_norm(p["mix"]["norm"], x, cfg.norm_eps)
    if kind == ATTN:
        decode = L.attention_decode_ring if ring else L.attention_decode
        y, ck, cv = decode(p["mix"], cfg, h, cache["k"], cache["v"], index)
        cache = {"k": ck, "v": cv}
    else:
        y, cache = M.mamba_decode(p["mix"], cfg, h, cache)
    return _apply_ffn(p, cfg, ffn, x + y), cache


def init_block_cache(cfg: ModelConfig, kind: str, ffn: str, batch: int,
                     max_len: int, dtype: torch.dtype, device: torch.device
                     ) -> Params:
    """Zero cache of one block: K and V [batch, max_len, KV, D] for
    attention, the O(1) SSM state otherwise."""
    _require_ported(kind, ffn)
    if kind == ATTN:
        shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    return M.init_mamba_cache(cfg, batch, dtype, device)


def _zero_aux(device: torch.device) -> Dict[str, torch.Tensor]:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"load_balance_loss": z, "router_z_loss": z, "expert_frac_max": z,
            "n_moe": z}


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


class LM:
    """Functional language model: ``params`` tree in, tensors out.

    ``attn_impl=None`` picks full-sequence attention from the device: the
    CUDA ``flash_attention`` kernel (``"kernel"``) on a CUDA device, the
    reference's ``"auto"`` rule (naive up to 2048 positions, blocked
    beyond) on the CPU; the prefill's attention takes the same path.
    ``use_ssd_kernel=None`` picks the prefill SSD
    likewise: the CUDA ``ssd_scan`` kernel on a CUDA device, the plain
    ``ssd_reference`` on the CPU.  An explicit value of either runs that
    path on any device, for comparison only.  ``ring_cache``: a
    sliding-window model keeps a rolling KV cache of ``min(max_len,
    window)`` slots (the reference's option; off without a window).
    ``fused_xent`` (the reference's sharded-vocab loss form) and
    ``window_slice`` (item 13.7) are not ported: the trainer and the
    engine never set them.
    """

    def __init__(self, cfg: ModelConfig, attn_impl: Optional[str] = None,
                 use_ssd_kernel: Optional[bool] = None,
                 fused_xent: bool = False, ring_cache: bool = False,
                 window_slice: bool = False, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        on_card = self.device.type == "cuda"
        if attn_impl is not None and attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {attn_impl!r}; expected "
                             f"one of {ATTN_IMPLS}")
        self.attn_impl = (("kernel" if on_card else "auto")
                          if attn_impl is None else attn_impl)
        self.use_ssd_kernel = (on_card if use_ssd_kernel is None
                               else use_ssd_kernel)
        if fused_xent:
            raise NotImplementedError(
                "fused_xent (the reference's sharded-vocab cross-entropy) "
                "is not ported; LM.loss takes log_softmax")
        L._refuse_window_slice(window_slice)
        self.ring_cache = ring_cache and cfg.sliding_window > 0
        self.dtype = getattr(torch, cfg.dtype)
        for kind, ffn in cfg.block_pattern():
            _require_ported(kind, ffn)
        if cfg.n_codebooks > 1 or cfg.num_prefix_embeddings:
            raise NotImplementedError(
                f"{cfg.name}: multi-codebook heads and prefix embeddings "
                "come with item 13.5 of the port")
        if not cfg.scan_layers:
            raise NotImplementedError(
                f"{cfg.name}: the port stacks layer groups; unstacked "
                "(scan_layers=False) trees are not ported")
        self.prefix, self.group, self.n_groups = layer_groups(cfg)
        # a uniform pattern (all the ported models have) splits with no
        # prefix
        assert not self.prefix, self.prefix

    # -- init ---------------------------------------------------------------

    def init(self, gen: torch.Generator) -> Params:
        """Random parameters drawn from ``gen`` on its device, placed on
        the model's."""
        cfg = self.cfg
        params: Params = {
            "embed": L.embed_init(gen, (cfg.vocab_size, cfg.d_model)),
            "final_norm": L.init_rms_norm(cfg.d_model, gen.device)}
        if not cfg.tie_embeddings:
            params["lm_head"] = L.dense_init(gen, (cfg.d_model,
                                                   cfg.vocab_size))
        groups = [{f"sub{i}": init_block(gen, cfg, kind, ffn)
                   for i, (kind, ffn) in enumerate(self.group)}
                  for _ in range(self.n_groups)]
        params["groups"] = _stack(groups)
        return tree_map(lambda t: t.to(self.device), params)

    # -- embedding ----------------------------------------------------------

    def embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens.long()].to(self.dtype)      # [B, S, d]

    def unembed(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return x @ params["embed"].to(x.dtype).T
        return x @ params["lm_head"].to(x.dtype)

    # -- forward (train / scoring) ------------------------------------------

    def _group_fn(self, p_group: Params, x: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
        for i, (kind, ffn) in enumerate(self.group):
            x = apply_block(p_group[f"sub{i}"], self.cfg, kind, ffn, x,
                            positions, self.attn_impl, self.use_ssd_kernel)
        return x

    def forward(self, params: Params, tokens: torch.Tensor,
                last_only: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        x = self.embed(params, tokens)
        positions = torch.arange(x.shape[1], device=x.device)
        # remat: keep only each group's input; its activations are
        # recomputed in the backward (forward-only calls skip it)
        remat = cfg.remat and torch.is_grad_enabled()
        for p_group in _unstack(params["groups"]):
            if remat:
                x = checkpoint(self._group_fn, p_group, x, positions,
                               use_reentrant=False)
            else:
                x = self._group_fn(p_group, x, positions)
        x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
        if last_only:
            x = x[:, -1:]
        return self.unembed(params, x), _zero_aux(x.device)

    # -- loss ---------------------------------------------------------------

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross-entropy (+ MoE aux, zero for the ported
        blocks). batch: tokens [B, S]; optional loss_mask [B, S-1]."""
        tokens = batch["tokens"]
        logits, aux = self.forward(params, tokens)
        pred = logits[:, :-1]                               # [B, S-1, V]
        tgt = tokens[:, 1:].long()
        logp = torch.log_softmax(pred.float(), dim=-1)
        nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(nll.shape, dtype=torch.float32,
                              device=nll.device)
        else:
            mask = torch.broadcast_to(mask, nll.shape).float()
        ce = (nll * mask).sum() / mask.sum().clamp_min(1.0)
        metrics = {"ce_loss": ce, "loss": ce,
                   "load_balance_loss": aux["load_balance_loss"],
                   "router_z_loss": aux["router_z_loss"]}
        return ce, metrics

    # -- serving -------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int) -> Params:
        """Zero decode cache for ``batch`` slots: attention layers hold
        ``max_len`` positions (a ring cache ``min(max_len, window)``), SSM
        layers O(1) state."""
        cfg = self.cfg
        if self.ring_cache:
            # ring length == window: slots cover (index - window, index]
            max_len = min(max_len, cfg.sliding_window)
        groups = [{f"sub{i}": init_block_cache(cfg, kind, ffn, batch,
                                               max_len, self.dtype,
                                               self.device)
                   for i, (kind, ffn) in enumerate(self.group)}
                  for _ in range(self.n_groups)]
        return {"index": torch.zeros((), dtype=torch.int32,
                                     device=self.device),
                "groups": _stack(groups)}

    def _run_layers(self, params: Params, cache: Params, x: torch.Tensor,
                    block_fn) -> Tuple[torch.Tensor, Params]:
        """Thread ``x`` through every block with ``block_fn(p, kind, ffn,
        x, c) -> (x, c)``; return x and the new stacked group caches (a
        cache leaf the blocks wrote in place is the one given)."""
        old_groups = _unstack(cache["groups"])
        new_groups = []
        for p_group, c_group in zip(_unstack(params["groups"]), old_groups):
            new_c = {}
            for i, (kind, ffn) in enumerate(self.group):
                x, new_c[f"sub{i}"] = block_fn(
                    p_group[f"sub{i}"], kind, ffn, x, c_group[f"sub{i}"])
            new_groups.append(new_c)
        return x, _restack(new_groups, old_groups, cache["groups"])

    def decode_step(self, params: Params, tokens: torch.Tensor,
                    cache: Params) -> Tuple[torch.Tensor, Params]:
        """One-token decode. tokens: [B, 1].  The position is the cache's
        ``index``, a device tensor: nothing is read back to the host."""
        cfg = self.cfg
        index = cache["index"]
        x = self.embed(params, tokens)                              # [B,1,d]
        x, groups = self._run_layers(
            params, cache, x,
            lambda p, kind, ffn, x, c: apply_block_decode(
                p, cfg, kind, ffn, x, c, index, self.ring_cache))
        new_cache = {"index": index + 1, "groups": groups}
        x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
        return self.unembed(params, x), new_cache

    def prefill(self, params: Params, tokens: torch.Tensor, cache: Params
                ) -> Tuple[torch.Tensor, Params]:
        """Run the full prompt through the model, filling the decode cache.

        Attention layers write K/V for positions [0, S); SSM layers store
        their final recurrent + conv state (from a zero state, as the
        reference).  Returns full-sequence logits and the filled cache
        (index advanced by S).
        """
        cfg = self.cfg
        x = self.embed(params, tokens)
        s = x.shape[1]
        positions = torch.arange(s, device=x.device)
        x, groups = self._run_layers(
            params, cache, x,
            lambda p, kind, ffn, x, c: apply_block_fill(
                p, cfg, kind, ffn, x, positions, c, self.attn_impl,
                self.use_ssd_kernel, self.ring_cache))
        new_cache = {"index": cache["index"] + s, "groups": groups}
        x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
        return self.unembed(params, x), new_cache

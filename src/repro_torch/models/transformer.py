"""Decoder-only language model over the ModelConfig space (port of
``repro.models.transformer``).

One implementation covers every LM architecture of the reference, each
through forward, ``loss`` (and its gradient), ``prefill`` and
``decode_step``.  A layer is a mixer, attention (``ATTN``) or Mamba-2
(``MAMBA``), and an FFN, dense (``DENSE_FFN``), mixture-of-experts
(``MOE_FFN``) or none (``NO_FFN``), in any combination: ``(MAMBA,
NO_FFN)`` (mamba2-370m), ``(ATTN, DENSE_FFN)`` (the dense zoo,
musicgen-medium, paligemma-3b), ``(ATTN, MOE_FFN)`` (olmoe-1b-7b;
deepseek-moe-16b after its dense first layer), and jamba-1.5's hybrid
stack, whose 8-layer group interleaves ``(MAMBA, DENSE_FFN)``, ``(MAMBA,
MOE_FFN)`` and ``(ATTN, DENSE_FFN)`` (its smoke config ``(ATTN,
MOE_FFN)``).  A multi-codebook model (musicgen-medium) takes tokens
``[B, CB, S]``, sums the codebooks' embeddings and has one head per
codebook (logits ``[B, CB, S, V]``); a prefix-embedding model
(paligemma-3b) takes precomputed ``prefix_emb [B, P, d]`` placed before
the text in ``forward``, ``loss`` and ``prefill``.
Every full-sequence attention (the forward's and the prefill's) runs
through the ``flash_attention`` kernel on the card, every SSD through
``ssd_scan``.  A MoE block returns its router's aux values, which
``forward`` sums over layers with the reference's tree add (so
``expert_frac_max``, a max within a block, is a sum across layers, as
there) and ``loss`` weighs into the loss.

Parameter and cache trees have the reference's shape, so weights and
caches carry across (``repro_torch.interop``): the layer pattern splits
into unstacked ``prefix_layers`` (a list; deepseek-moe's dense first
layer at depth 4 and beyond) and ``n_groups`` repetitions of a group.
With ``cfg.scan_layers`` (every LM config) the groups' leaves are stacked
on a leading ``[n_groups]`` axis; without it ``groups`` is a list of
per-group trees, as the reference's unstacked model.  The cache holds a
scalar ``index``.  Where the reference scans over the stacked groups, the
port unbinds them once (one autograd node per leaf, whose backward stacks
the groups' gradients) and loops in Python; ``cfg.remat`` checkpoints
each group as ``jax.checkpoint`` does.  An attention layer writes its
K/V rows into its group's view of the stacked cache (or its own cache
in a list) in place, so ``prefill`` and ``decode_step`` return the cache
they were given with those rows (and the index) updated, where the
reference returns a new one with the same values; an SSM layer's state
is small and is returned new (restacked, in a stacked tree), so one
group of the hybrid stack keeps its attention sub's K/V and takes new
SSM state.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ATTN, DENSE_FFN, MOE_FFN, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.interop import tree_map
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MoE
from repro_torch.models.layers import Params

ATTN_IMPLS = ("kernel", "naive", "blocked", "auto")


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
    """Stack same-shaped trees leaf by leaf on a new leading axis (one
    tree's leaves as views with that axis added: no copy, so a model of
    one group never holds its weights twice)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if len(trees) == 1:
        return trees[0].unsqueeze(0)
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
    p: Params = {"mix": L.init_attention(gen, cfg) if kind == ATTN
                 else M.init_mamba(gen, cfg)}
    if ffn == DENSE_FFN:
        p["ffn"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff)
    elif ffn == MOE_FFN:
        p["ffn"] = MoE.init_moe(gen, cfg)
    return p


def _zero_aux(device: torch.device) -> Dict[str, torch.Tensor]:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"load_balance_loss": z, "router_z_loss": z, "expert_frac_max": z,
            "n_moe": z}


def _add_aux(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
    """The reference's ``jax.tree.map(jnp.add, a, b)`` over aux dicts."""
    return {k: a[k] + b[k] for k in a}


def _apply_ffn(p: Params, cfg: ModelConfig, ffn: str, x: torch.Tensor,
               token_group=None
               ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """The block's FFN half: x and, for a MoE FFN, its router's aux
    (``token_group``: the ranks the step's rows split over, whose tokens
    a MoE FFN dispatches as one step's)."""
    if ffn == DENSE_FFN:
        h = L.rms_norm(p["ffn"]["norm"], x, cfg.norm_eps)
        return x + L.mlp(p["ffn"], h, cfg.act_fn), None
    if ffn == MOE_FFN:
        h = L.rms_norm(p["ffn"]["norm"], x, cfg.norm_eps)
        y, moe_aux = MoE.moe_ffn(p["ffn"], cfg, h, token_group)
        return x + y, moe_aux
    return x, None


def apply_block(p: Params, cfg: ModelConfig, kind: str, ffn: str,
                x: torch.Tensor, positions: torch.Tensor,
                attn_impl: str = "auto", window_slice: bool = False,
                use_ssd_kernel: bool = False, token_group=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence block: (x, aux), aux zero but for a MoE FFN (whose
    ``expert_frac_max`` enters as a max, the rest as sums)."""
    aux = _zero_aux(x.device)
    h = L.rms_norm(p["mix"]["norm"], x, cfg.norm_eps)
    if kind == ATTN:
        x = x + L.attention(p["mix"], cfg, h, positions, impl=attn_impl,
                            window_slice=window_slice)
    else:
        x = x + M.mamba_mixer(p["mix"], cfg, h, use_kernel=use_ssd_kernel)
    x, moe_aux = _apply_ffn(p, cfg, ffn, x, token_group)
    if moe_aux is not None:
        for k in ("load_balance_loss", "router_z_loss"):
            aux[k] = aux[k] + moe_aux[k]
        aux["expert_frac_max"] = torch.maximum(aux["expert_frac_max"],
                                               moe_aux["expert_frac_max"])
        aux["n_moe"] = aux["n_moe"] + 1.0
    return x, aux


def apply_block_fill(p: Params, cfg: ModelConfig, kind: str, ffn: str,
                     x: torch.Tensor, positions: torch.Tensor,
                     cache: Params, attn_impl: str = "auto",
                     window_slice: bool = False, use_ssd_kernel: bool = False,
                     ring: bool = False) -> Tuple[torch.Tensor, Params]:
    """Full-sequence block that also fills the decode cache (prefill):
    an attention layer writes its K/V into ``cache`` in place (a ring
    cache with ``ring``), an SSM layer returns its final state."""
    h = L.rms_norm(p["mix"]["norm"], x, cfg.norm_eps)
    if kind == ATTN:
        fill = L.attention_fill_ring if ring else L.attention_fill
        y, ck, cv = fill(p["mix"], cfg, h, positions, cache["k"],
                         cache["v"], impl=attn_impl,
                         window_slice=window_slice)
        cache = {"k": ck, "v": cv}
    else:
        y, cache = M.mamba_mixer_with_state(p["mix"], cfg, h,
                                            use_kernel=use_ssd_kernel)
    return _apply_ffn(p, cfg, ffn, x + y)[0], cache


def apply_block_decode(p: Params, cfg: ModelConfig, kind: str, ffn: str,
                       x: torch.Tensor, cache: Params, index: torch.Tensor,
                       window_slice: bool = False, ring: bool = False,
                       token_group=None, kv_split=None
                       ) -> Tuple[torch.Tensor, Params]:
    """One-token block at position ``index`` (a 0-d device tensor); a
    ring cache ignores ``window_slice``, as in the reference.
    ``kv_split``: the K/V block's share of a sequence split over ranks
    (``repro_torch.train.layout.KVSplit``; split-KV attention, which reads
    every valid key of its block, so ``window_slice`` changes nothing; a
    ring cache's slots split the same way)."""
    h = L.rms_norm(p["mix"]["norm"], x, cfg.norm_eps)
    if kind == ATTN:
        if kv_split is not None:
            y, ck, cv = L.attention_decode_split(p["mix"], cfg, h,
                                                 cache["k"], cache["v"],
                                                 index, kv_split, ring)
        elif ring:
            y, ck, cv = L.attention_decode_ring(p["mix"], cfg, h, cache["k"],
                                                cache["v"], index)
        else:
            y, ck, cv = L.attention_decode(p["mix"], cfg, h, cache["k"],
                                           cache["v"], index,
                                           window_slice=window_slice)
        cache = {"k": ck, "v": cv}
    else:
        y, cache = M.mamba_decode(p["mix"], cfg, h, cache)
    return _apply_ffn(p, cfg, ffn, x + y, token_group)[0], cache


def init_block_cache(cfg: ModelConfig, kind: str, ffn: str, batch: int,
                     max_len: int, dtype: torch.dtype, device: torch.device
                     ) -> Params:
    """Zero cache of one block: K and V [batch, max_len, KV, D] for
    attention, the O(1) SSM state otherwise."""
    if kind == ATTN:
        shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    return M.init_mamba_cache(cfg, batch, dtype, device)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


class LM:
    """Functional language model: ``params`` tree in, tensors out.

    ``attn_impl=None`` picks full-sequence attention from the device: the
    CUDA ``flash_attention`` kernel (``"kernel"``) on a CUDA device, the
    reference's ``"auto"`` rule (naive up to 2048 positions, blocked
    beyond) on the CPU; the prefill's attention takes the same path.
    ``use_ssd_kernel=None`` picks the full-sequence SSD (prefill and
    training) likewise: the CUDA ``ssd_scan`` kernel on a CUDA device, the
    plain ``ssd_reference`` on the CPU.  An explicit value of either runs that
    path on any device, for comparison only.  ``ring_cache``: a
    sliding-window model keeps a rolling KV cache of ``min(max_len,
    window)`` slots (the reference's option; off without a window).
    ``fused_xent``: the loss as ``logsumexp`` less the label's logit (the
    reference's form for a vocab-sharded loss; the same value, the label
    logit taken by ``gather`` where the reference contracts a one-hot).
    ``window_slice``: a sliding-window model's blocked attention and
    decode read only the keys the window can reach (the reference's
    option; the values are the masked path's).

    ``param_hook``: ``None`` (the default), or ``hook(tree, *key)`` giving
    the parameters at ``key`` (``"embed"``, ``"lm_head"``,
    ``"final_norm"``, ``("prefix_layers", i)`` or ``"groups"``, one
    group's tree) as the layers use them, called where they are used:
    ``repro_torch.federated.local_sgd`` gathers the shards of a model split
    over ranks there, a group's inside its ``checkpoint`` (so a group's
    full weights live only during its forward and its recompute).

    Over a mesh (``repro_torch.train.state``'s ``mesh=`` steps set these
    on a copy of the model): ``token_group`` is the group a step's batch
    rows split over (the loss is a masked mean over the whole batch, MoE
    layers dispatch the whole step's tokens); ``cache_layout`` a decode
    cache held as a rank's blocks (``repro_torch.train.layout.
    CacheLayout.run`` wraps each decode block; its ``kv_split`` the
    rank's share of a sequence-split K/V).
    """

    param_hook = None
    token_group = None
    cache_layout = None

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
        self.fused_xent = fused_xent
        self.window_slice = window_slice
        self.ring_cache = ring_cache and cfg.sliding_window > 0
        self.dtype = getattr(torch, cfg.dtype)
        self.prefix, self.group, self.n_groups = layer_groups(cfg)

    # -- init ---------------------------------------------------------------

    def init(self, gen: Optional[torch.Generator]) -> Params:
        """Random parameters drawn from ``gen`` on its device, placed on
        the model's.  ``gen=None`` on a ``meta`` model builds the tree's
        shapes, dtypes and key paths only (``meta`` leaves, nothing
        drawn): the counterpart of ``jax.eval_shape(model.init)``, which
        the planner (``repro_torch.launch.dryrun``) traces on."""
        if gen is None:
            if self.device.type != "meta":
                raise ValueError("LM.init(None) builds a shape-only tree "
                                 f"and needs a meta model, not "
                                 f"{self.device}")
            gen = SimpleNamespace(device=self.device)
        cfg = self.cfg
        cb = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
        params: Params = {
            "embed": L.embed_init(gen, cb + (cfg.vocab_size, cfg.d_model)),
            "final_norm": L.init_rms_norm(cfg.d_model, gen.device)}
        if not cfg.tie_embeddings:
            params["lm_head"] = L.dense_init(
                gen, cb + (cfg.d_model, cfg.vocab_size),
                in_axis_size=cfg.d_model)
        if self.prefix:
            params["prefix_layers"] = [init_block(gen, cfg, kind, ffn)
                                       for kind, ffn in self.prefix]
        params["groups"] = self._pack([
            {f"sub{i}": init_block(gen, cfg, kind, ffn)
             for i, (kind, ffn) in enumerate(self.group)}
            for _ in range(self.n_groups)])
        return tree_map(lambda t: t.to(self.device), params)

    def _pack(self, groups: List[Params]) -> Any:
        """Per-group trees as the model's ``groups``: stacked with
        ``cfg.scan_layers``, else the list itself."""
        return _stack(groups) if self.cfg.scan_layers else groups

    def _use(self, tree: Params, *key) -> Params:
        """The parameters ``tree`` at ``key`` as the layers use them
        (``param_hook``'s)."""
        return tree if self.param_hook is None else self.param_hook(tree,
                                                                    *key)

    def _groups(self, tree: Params) -> List[Params]:
        """A params or cache tree's groups as one tree per group (views
        of a stacked tree)."""
        groups = tree["groups"]
        return _unstack(groups) if self.cfg.scan_layers else list(groups)

    # -- embedding ----------------------------------------------------------

    def embed(self, params: Params, tokens: torch.Tensor,
              prefix_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, P + S, d]: the prefix embeddings (if any), then the tokens'
        (``[B, S]``, or ``[B, CB, S]`` summed over the codebooks)."""
        emb = self._use(params["embed"], "embed")
        if self.cfg.n_codebooks > 1:
            cb = torch.arange(self.cfg.n_codebooks,
                              device=tokens.device)[None, :, None]
            x = emb[cb, tokens.long()].to(self.dtype).sum(1)
        else:
            x = emb[tokens.long()].to(self.dtype)
        if prefix_emb is not None:
            x = torch.cat([prefix_emb.to(self.dtype), x], dim=1)
        return x

    def unembed(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """Logits [B, S, V], or [B, CB, S, V] from per-codebook heads (a
        tied embedding wins, as in the reference)."""
        if self.cfg.tie_embeddings:
            return x @ self._use(params["embed"], "embed").to(x.dtype).T
        head = self._use(params["lm_head"], "lm_head")
        if self.cfg.n_codebooks > 1:
            return torch.einsum("bsd,cdv->bcsv", x, head.to(x.dtype))
        return x @ head.to(x.dtype)

    # -- forward (train / scoring) ------------------------------------------

    def _block(self, p: Params, kind: str, ffn: str, x: torch.Tensor,
               positions: torch.Tensor
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return apply_block(p, self.cfg, kind, ffn, x, positions,
                           self.attn_impl, self.window_slice,
                           self.use_ssd_kernel, self.token_group)

    def _group_fn(self, p_group: Params, x: torch.Tensor,
                  positions: torch.Tensor
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        aux = _zero_aux(x.device)
        p_group = self._use(p_group, "groups")
        for i, (kind, ffn) in enumerate(self.group):
            x, a = self._block(p_group[f"sub{i}"], kind, ffn, x, positions)
            aux = _add_aux(aux, a)
        return x, aux

    def forward(self, params: Params, tokens: torch.Tensor,
                prefix_emb: Optional[torch.Tensor] = None,
                last_only: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        x = self.embed(params, tokens, prefix_emb)
        positions = torch.arange(x.shape[1], device=x.device)
        aux = _zero_aux(x.device)
        for i, (p_layer, (kind, ffn)) in enumerate(zip(
                params.get("prefix_layers", []), self.prefix)):
            x, a = self._block(self._use(p_layer, "prefix_layers", i), kind,
                               ffn, x, positions)
            aux = _add_aux(aux, a)
        # remat: keep only each group's input; its activations are
        # recomputed in the backward (forward-only calls skip it)
        remat = cfg.remat and torch.is_grad_enabled()
        for p_group in self._groups(params):
            if remat:
                x, a = checkpoint(self._group_fn, p_group, x, positions,
                                  use_reentrant=False)
            else:
                x, a = self._group_fn(p_group, x, positions)
            aux = _add_aux(aux, a)
        x = L.rms_norm(self._use(params["final_norm"], "final_norm"), x,
                       cfg.norm_eps)
        if last_only:
            x = x[:, -1:]
        return self.unembed(params, x), aux

    # -- loss ---------------------------------------------------------------

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross-entropy (+ the MoE router's aux losses).
        batch: tokens [B, S] or [B, CB, S]; optional prefix_emb [B, P, d]
        (the logits at the prefix's positions, its last included, are
        not scored); optional loss_mask [B, S-1]."""
        tokens = batch["tokens"]
        prefix_emb = batch.get("prefix_emb")
        logits, aux = self.forward(params, tokens, prefix_emb)
        n_prefix = prefix_emb.shape[1] if prefix_emb is not None else 0
        if self.cfg.n_codebooks > 1:
            pred = logits[:, :, :-1]                        # [B,CB,S-1,V]
            tgt = tokens[:, :, 1:].long()                   # [B,CB,S-1]
        else:
            pred = logits[:, n_prefix:-1]                   # [B, S-1, V]
            tgt = tokens[:, 1:].long()
        if self.fused_xent:
            logits32 = pred.float()
            label = torch.gather(logits32, -1, tgt[..., None])[..., 0]
            nll = torch.logsumexp(logits32, dim=-1) - label
        else:
            logp = torch.log_softmax(pred.float(), dim=-1)
            nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(nll.shape, dtype=torch.float32,
                              device=nll.device)
        else:
            mask = torch.broadcast_to(mask, nll.shape).float()
        if self.token_group is None:
            ce = (nll * mask).sum() / mask.sum().clamp_min(1.0)
        else:
            # a rank's rows: its share of the batch's masked sum over the
            # batch's count; the value is the batch's
            from repro_torch.launch.mesh import gather_edge_stack
            num = (nll * mask).sum()
            every = gather_edge_stack(torch.stack(
                [num.detach(), mask.sum()])[None], self.token_group)
            den = every[:, 1].sum().clamp_min(1.0)
            ce = num / den
            ce = ce + (every[:, 0].sum() / den - ce).detach()
        loss = ce
        m = self.cfg.moe
        if m.enabled:
            loss = loss + m.router_aux_loss * aux["load_balance_loss"]
            loss = loss + m.router_z_loss * aux["router_z_loss"]
        metrics = {"ce_loss": ce, "loss": loss,
                   "load_balance_loss": aux["load_balance_loss"],
                   "router_z_loss": aux["router_z_loss"]}
        return loss, metrics

    # -- serving -------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int, mesh=None) -> Params:
        """Zero decode cache for ``batch`` slots: attention layers hold
        ``max_len`` positions (a ring cache ``min(max_len, window)``), SSM
        layers O(1) state; prefix layers' caches unstacked
        (``prefix_layers``, batch-leading), the groups' as the
        parameters' (stacked, or a list).  ``mesh``: this rank's blocks
        of it in ``cache_specs``' layout
        (``repro_torch.train.layout.CacheLayout``)."""
        if mesh is not None:
            from repro_torch.train.layout import CacheLayout
            return CacheLayout(self, mesh, batch, max_len).init(self.device)
        cfg = self.cfg
        if self.ring_cache:
            # ring length == window: slots cover (index - window, index]
            max_len = min(max_len, cfg.sliding_window)

        def block_cache(kind, ffn):
            return init_block_cache(cfg, kind, ffn, batch, max_len,
                                    self.dtype, self.device)
        cache: Params = {"index": torch.zeros((), dtype=torch.int32,
                                              device=self.device)}
        if self.prefix:
            cache["prefix_layers"] = [block_cache(kind, ffn)
                                      for kind, ffn in self.prefix]
        cache["groups"] = self._pack([
            {f"sub{i}": block_cache(kind, ffn)
             for i, (kind, ffn) in enumerate(self.group)}
            for _ in range(self.n_groups)])
        return cache

    def _run_layers(self, params: Params, cache: Params, x: torch.Tensor,
                    block_fn) -> Tuple[torch.Tensor, Params]:
        """Thread ``x`` through every block, the prefix layers first, with
        ``block_fn(p, kind, ffn, x, c) -> (x, c)``; return x and the new
        cache's layers: ``prefix_layers`` (a list) where the model has
        them, and ``groups``, stacked or a list as given.  In a stacked
        tree each sub's leaves are restacked apart: a leaf every group
        wrote in place (an attention sub's K/V) is the one given, a leaf
        the blocks returned new (an SSM sub's state) is stacked anew."""
        layers: Params = {}
        if self.cache_layout is not None:
            run, index = self.cache_layout.run, cache["index"]

            def block_fn(p, kind, ffn, x, c, *key, _fn=block_fn):
                return run(_fn, p, kind, ffn, x, c, index, key)
        else:
            def block_fn(p, kind, ffn, x, c, *key, _fn=block_fn):
                return _fn(p, kind, ffn, x, c)
        if self.prefix:
            new_prefix = []
            for i, (p_layer, c_layer, (kind, ffn)) in enumerate(zip(
                    params["prefix_layers"], cache["prefix_layers"],
                    self.prefix)):
                x, c = block_fn(self._use(p_layer, "prefix_layers", i),
                                kind, ffn, x, c_layer, "prefix_layers", i)
                new_prefix.append(c)
            layers["prefix_layers"] = new_prefix
        old_groups = self._groups(cache)
        new_groups = []
        for p_group, c_group in zip(self._groups(params), old_groups):
            p_group = self._use(p_group, "groups")
            new_c = {}
            for i, (kind, ffn) in enumerate(self.group):
                x, new_c[f"sub{i}"] = block_fn(
                    p_group[f"sub{i}"], kind, ffn, x, c_group[f"sub{i}"],
                    "groups", f"sub{i}")
            new_groups.append(new_c)
        layers["groups"] = (
            _restack(new_groups, old_groups, cache["groups"])
            if self.cfg.scan_layers else new_groups)
        return x, layers

    def decode_step(self, params: Params, tokens: torch.Tensor,
                    cache: Params) -> Tuple[torch.Tensor, Params]:
        """One-token decode. tokens: [B, 1] (or [B, CB, 1]
        multi-codebook; logits [B, CB, 1, V]).  The position is the
        cache's ``index``, a device tensor: nothing is read back to the
        host."""
        cfg = self.cfg
        index = cache["index"]
        x = self.embed(params, tokens)                              # [B,1,d]
        x, layers = self._run_layers(
            params, cache, x,
            lambda p, kind, ffn, x, c: apply_block_decode(
                p, cfg, kind, ffn, x, c, index, self.window_slice,
                self.ring_cache, self.token_group,
                None if self.cache_layout is None
                else self.cache_layout.kv_split))
        new_cache = {"index": index + 1, **layers}
        x = L.rms_norm(self._use(params["final_norm"], "final_norm"), x,
                       cfg.norm_eps)
        return self.unembed(params, x), new_cache

    def prefill(self, params: Params, tokens: torch.Tensor, cache: Params,
                prefix_emb: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Params]:
        """Run the full prompt (after ``prefix_emb``'s P positions, if
        given) through the model, filling the decode cache.

        Attention layers write K/V for positions [0, P + S); SSM layers
        store their final recurrent + conv state (from a zero state, as
        the reference).  Returns full-sequence logits and the filled cache
        (index advanced by P + S).
        """
        cfg = self.cfg
        if self.cache_layout is not None:
            raise NotImplementedError(
                "prefill into a cache held as a rank's blocks: fill the "
                "whole cache and cut it (CacheLayout.shard), or run "
                "make_prefill_step(mesh=)")
        x = self.embed(params, tokens, prefix_emb)
        s = x.shape[1]
        positions = torch.arange(s, device=x.device)
        x, layers = self._run_layers(
            params, cache, x,
            lambda p, kind, ffn, x, c: apply_block_fill(
                p, cfg, kind, ffn, x, positions, c, self.attn_impl,
                self.window_slice, self.use_ssd_kernel, self.ring_cache))
        new_cache = {"index": cache["index"] + s, **layers}
        x = L.rms_norm(self._use(params["final_norm"], "final_norm"), x,
                       cfg.norm_eps)
        return self.unembed(params, x), new_cache

"""Train state + step factories (port of ``repro.train.state``).

The gradient is ``torch.autograd.grad`` of ``model.loss`` over the
parameter tree's leaves; the update is ``apply_updates``, in place.

With ``mesh=`` (a ``repro_torch.launch.mesh.Mesh``, or a ``PlanMesh`` in
a plan) each factory builds ONE rank's share of the step, the reference's
dry-run layouts run on ranks (``repro_torch.train.layout``): the train
step holds the rank's blocks of ``param_specs(fsdp=True)`` and takes its
``global_batch / (pod * data)`` rows; the prefill and decode steps hold
``param_specs(fsdp=False)`` blocks, the prefill the rank's rows, the
decode its blocks of ``cache_specs``.  Each step's ``layout`` (and the
decode step's ``cache_layout(batch, max_len)``) carries whole trees to a
rank's blocks and back.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.config import TrainConfig
from repro_torch.interop import tree_map
from repro_torch.train.optimizer import OptState, apply_updates, \
    init_opt_state

Params = Any


class TrainState(NamedTuple):
    params: Params
    opt: OptState


def init_train_state(model, train_cfg: TrainConfig,
                     gen: torch.Generator) -> TrainState:
    params = model.init(gen)
    return TrainState(params=params, opt=init_opt_state(train_cfg, params))


def loss_and_grads(model, params: Params, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict[str, torch.Tensor], Params]:
    """``model.loss`` and its gradient tree (same structure as
    ``params``); the metrics are detached, so holding them keeps no
    activations alive."""
    leaves = []

    def track(p: torch.Tensor) -> torch.Tensor:
        leaves.append(p.detach().requires_grad_())
        return leaves[-1]

    tracked = tree_map(track, params)
    loss, metrics = model.loss(tracked, batch)
    it = iter(torch.autograd.grad(loss, leaves))
    grads = tree_map(lambda _: next(it), tracked)
    return {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(model, train_cfg: TrainConfig, full_leaves=None, *,
                    mesh=None):
    """Standard synchronous train step: grad -> clip -> update.  The
    state's parameters and moments are updated in place.
    ``full_leaves``: the clip's, for a state of shards
    (``repro_torch.train.optimizer.clip_by_global_norm``).

    ``mesh``: one rank's share, ``train_step(state, batch)`` with the
    rank's blocks of the ``TrainState`` (``train_step.layout.shard_state``)
    and its rows of the batch (``repro_torch.train.layout.local_rows``):
    the loss is the masked mean over the whole batch, MoE layers dispatch
    the whole step's tokens, each gradient is summed over the edge ranks
    in rank order, the clip's norm reads whole leaves, and AdamW updates
    the blocks."""
    layout = None
    if mesh is not None:
        from repro_torch.train.layout import ParamLayout
        layout = ParamLayout.for_model(model, mesh, fsdp=True)
        model = layout.hooked(model, layout.edge_group)
        full_leaves = layout.full_leaves

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        metrics, grads = loss_and_grads(model, state.params, batch)
        params, opt, opt_metrics = apply_updates(
            train_cfg, state.params, grads, state.opt, full_leaves)
        return TrainState(params, opt), dict(metrics, **opt_metrics)

    train_step.layout = layout
    return train_step


def make_eval_step(model):
    def eval_step(params: Params, batch: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            _, metrics = model.loss(params, batch)
        return metrics

    return eval_step


def make_prefill_step(model, last_only: bool = False, *, mesh=None):
    """The forward over a batch (the reference's ``prefill_step``).
    ``mesh``: one rank's share, ``prefill_step(params, batch)`` with the
    rank's blocks of ``param_specs(fsdp=False)`` (``prefill_step.layout.
    shard``) and its rows of the batch; it returns the logits of its
    rows."""
    layout = None
    if mesh is not None:
        from repro_torch.train.layout import ParamLayout, edge_group
        layout = ParamLayout.for_model(model, mesh)
        model = layout.hooked(model, edge_group(mesh))

    def prefill_step(params: Params, batch: Dict[str, torch.Tensor]
                     ) -> torch.Tensor:
        with torch.no_grad():
            logits, _ = model.forward(params, batch["tokens"],
                                      batch.get("prefix_emb"),
                                      last_only=last_only)
        return logits

    prefill_step.layout = layout
    return prefill_step


def make_decode_step(model, *, mesh=None, batch: Optional[int] = None,
                     max_len: Optional[int] = None):
    """One token against a KV/SSM cache.  ``mesh`` (with the cache's
    global ``batch`` and ``max_len``): one rank's share,
    ``decode_step(params, tokens, cache)`` with the rank's blocks of
    ``param_specs(fsdp=False)`` and of ``cache_specs``
    (``LM.init_cache(batch, max_len, mesh=)``, or
    ``decode_step.cache_layout.shard`` of a whole cache): when the batch
    tiles the edge ranks, its rows of the tokens and logits; else every
    rank takes every row and the K/V sequence is split (split-KV
    attention)."""
    layout = cache_layout = None
    if mesh is not None:
        from repro_torch.train.layout import CacheLayout, ParamLayout
        if batch is None or max_len is None:
            raise ValueError("make_decode_step(mesh=) needs the cache's "
                             "global batch and max_len")
        layout = ParamLayout.for_model(model, mesh)
        cache_layout = CacheLayout(model, mesh, batch, max_len)
        model = layout.hooked(model, cache_layout.token_group)
        model.cache_layout = cache_layout

    def decode_step(params: Params, tokens: torch.Tensor, cache: Any
                    ) -> Tuple[torch.Tensor, Any]:
        with torch.no_grad():
            return model.decode_step(params, tokens, cache)

    decode_step.layout = layout
    decode_step.cache_layout = cache_layout
    return decode_step

"""Shape-only input stand-ins for every (arch x input-shape) combination
(port of ``repro.launch.specs``).

Every stand-in is a ``meta`` tensor: a shape and a dtype, no data and no
memory, where the reference builds ``jax.ShapeDtypeStruct``s.  The
planner (``repro_torch.launch.dryrun``) traces its steps on them.
``decode`` shapes describe ONE new token against a KV/SSM cache of
``seq_len``; ``train``/``prefill`` describe full sequences.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.config import INPUT_SHAPES, InputShape, ModelConfig

META = torch.device("meta")

# Sliding window applied to full-attention archs for the long-context shape
# (long_500k needs sub-quadratic attention).
LONG_CONTEXT_WINDOW = 8192


def _sds(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def adapt_model_for_shape(model_cfg: ModelConfig,
                          shape: InputShape) -> ModelConfig:
    """Per-shape config adjustments:

    * ``long_500k`` on attention architectures enables sliding-window
      attention (window 8192).  Pure/hybrid SSM archs run natively: mamba2
      has no attention; jamba keeps its 9 full-attention layers.
    """
    if shape.name == "long_500k" and model_cfg.family not in ("ssm", "hybrid"):
        return dataclasses.replace(model_cfg,
                                   sliding_window=LONG_CONTEXT_WINDOW)
    return model_cfg


def batch_struct(model_cfg: ModelConfig, batch: int, seq_len: int
                 ) -> Dict[str, Any]:
    """Training/prefill batch stand-in for one global step."""
    out: Dict[str, Any] = {}
    if model_cfg.n_codebooks > 1:
        out["tokens"] = _sds((batch, model_cfg.n_codebooks, seq_len),
                             torch.int32)
    else:
        out["tokens"] = _sds((batch, seq_len), torch.int32)
    if model_cfg.num_prefix_embeddings:
        out["prefix_emb"] = _sds(
            (batch, model_cfg.num_prefix_embeddings, model_cfg.d_model),
            getattr(torch, model_cfg.dtype))
    return out


def decode_token_struct(model_cfg: ModelConfig, batch: int) -> Any:
    if model_cfg.n_codebooks > 1:
        return _sds((batch, model_cfg.n_codebooks, 1), torch.int32)
    return _sds((batch, 1), torch.int32)


def input_specs(model_cfg: ModelConfig, shape_name: str) -> Dict[str, Any]:
    """The model-input stand-ins for one assigned input shape."""
    shape = INPUT_SHAPES[shape_name]
    model_cfg = adapt_model_for_shape(model_cfg, shape)
    if shape.kind in ("train", "prefill"):
        return batch_struct(model_cfg, shape.global_batch, shape.seq_len)
    return {"tokens": decode_token_struct(model_cfg, shape.global_batch)}


def el_round_batch_struct(model_cfg: ModelConfig, n_edges: int, h_max: int,
                          batch: int, seq_len: int) -> Dict[str, Any]:
    """Batch stand-in for one OL4EL round: per-edge, per-local-step."""
    per_edge = batch // n_edges
    if model_cfg.n_codebooks > 1:
        tokens = _sds((n_edges, h_max, per_edge, model_cfg.n_codebooks,
                       seq_len), torch.int32)
    else:
        tokens = _sds((n_edges, h_max, per_edge, seq_len), torch.int32)
    out: Dict[str, Any] = {"tokens": tokens}
    if model_cfg.num_prefix_embeddings:
        out["prefix_emb"] = _sds(
            (n_edges, h_max, per_edge, model_cfg.num_prefix_embeddings,
             model_cfg.d_model), getattr(torch, model_cfg.dtype))
    return out

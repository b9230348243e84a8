"""Deterministic synthetic LM data (port of ``repro.data.pipeline``).

Every edge server sees a reproducible, statistically distinct token
stream — the non-IID setting the paper's EL problem assumes: edge ``e``
draws tokens from a Zipf distribution over its own permutation of the
vocab, so the marginals differ across edges while global statistics
match.  ``batch(edge, step)`` is a pure function of (seed, edge, step).

The draws come from numpy (``default_rng`` seeded by ``[seed, edge,
step]``, the permutation by ``[1234, edge]``, a prefix-embedding model's
patch embeddings by ``[seed, edge, step, 7]``), not from ``jax.random``:
the stream has the reference's distribution but other values.  Tokens are
``[B, S]``, or ``[B, CB, S]`` for a model of ``CB > 1`` codebooks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device


def zipf_probs(vocab: int, alpha: float = 1.2) -> np.ndarray:
    p = np.arange(1, vocab + 1, dtype=np.float64) ** -alpha
    return p / p.sum()


def lm_batch(rng: np.random.Generator, batch: int, seq_len: int, vocab: int,
             edge_id: int = 0, alpha: float = 1.2,
             n_codebooks: int = 1) -> np.ndarray:
    """Sample a token batch for one edge. Shape [B, S] or [B, CB, S]."""
    perm = np.random.default_rng([1234, edge_id]).permutation(vocab)
    shape = ((batch, seq_len) if n_codebooks == 1
             else (batch, n_codebooks, seq_len))
    draws = rng.choice(vocab, size=shape, p=zipf_probs(vocab, alpha))
    return perm[draws].astype(np.int32)


@dataclasses.dataclass
class SyntheticLMData:
    """Counter-based synthetic stream: ``batch(edge, step)`` is pure."""

    vocab: int
    seq_len: int
    batch_size: int
    n_codebooks: int = 1
    n_prefix: int = 0
    d_model: int = 0
    seed: int = 0
    alpha: float = 1.2

    def batch(self, edge_id: int, step: int,
              device: DeviceLike = None) -> Dict[str, torch.Tensor]:
        """{"tokens": int32 [B, S] (or [B, CB, S])} on ``device`` (default
        CUDA), with ``"prefix_emb"``, f32 [B, n_prefix, d_model] of
        0.02 N(0, 1), when the stream has prefix embeddings."""
        dev = resolve_device(device)
        rng = np.random.default_rng([self.seed, edge_id, step])
        tokens = lm_batch(rng, self.batch_size, self.seq_len, self.vocab,
                          edge_id, self.alpha, self.n_codebooks)
        out = {"tokens": torch.from_numpy(tokens).to(dev)}
        if self.n_prefix:
            rng2 = np.random.default_rng([self.seed, edge_id, step, 7])
            prefix = 0.02 * rng2.standard_normal(
                (self.batch_size, self.n_prefix, self.d_model),
                dtype=np.float32)
            out["prefix_emb"] = torch.from_numpy(prefix).to(dev)
        return out

    @classmethod
    def for_model(cls, cfg: ModelConfig, batch_size: int, seq_len: int,
                  seed: int = 0) -> "SyntheticLMData":
        return cls(vocab=cfg.vocab_size, seq_len=seq_len,
                   batch_size=batch_size, n_codebooks=cfg.n_codebooks,
                   n_prefix=cfg.num_prefix_embeddings, d_model=cfg.d_model,
                   seed=seed)

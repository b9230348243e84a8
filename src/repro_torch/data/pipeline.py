"""Deterministic synthetic LM data (port of ``repro.data.pipeline``).

Every edge server sees a reproducible, statistically distinct token
stream — the non-IID setting the paper's EL problem assumes: edge ``e``
draws tokens from a Zipf distribution over its own permutation of the
vocab, so the marginals differ across edges while global statistics
match.  ``batch(edge, step)`` is a pure function of (seed, edge, step).

The draws come from numpy (``default_rng`` seeded by ``[seed, edge,
step]``, the permutation by ``[1234, edge]``), not from ``jax.random``:
the stream has the reference's distribution but other tokens.
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
             edge_id: int = 0, alpha: float = 1.2) -> np.ndarray:
    """Sample a token batch [B, S] for one edge."""
    perm = np.random.default_rng([1234, edge_id]).permutation(vocab)
    draws = rng.choice(vocab, size=(batch, seq_len),
                       p=zipf_probs(vocab, alpha))
    return perm[draws].astype(np.int32)


@dataclasses.dataclass
class SyntheticLMData:
    """Counter-based synthetic stream: ``batch(edge, step)`` is pure."""

    vocab: int
    seq_len: int
    batch_size: int
    seed: int = 0
    alpha: float = 1.2

    def batch(self, edge_id: int, step: int,
              device: DeviceLike = None) -> Dict[str, torch.Tensor]:
        """{"tokens": int32 [B, S]} on ``device`` (default CUDA).  The
        multi-codebook and prefix-embedding streams come with the models
        that read them."""
        dev = resolve_device(device)
        rng = np.random.default_rng([self.seed, edge_id, step])
        tokens = lm_batch(rng, self.batch_size, self.seq_len, self.vocab,
                          edge_id, self.alpha)
        return {"tokens": torch.from_numpy(tokens).to(dev)}

    @classmethod
    def for_model(cls, cfg: ModelConfig, batch_size: int, seq_len: int,
                  seed: int = 0) -> "SyntheticLMData":
        return cls(vocab=cfg.vocab_size, seq_len=seq_len,
                   batch_size=batch_size, seed=seed)

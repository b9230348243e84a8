"""Shared helpers for the config files."""

from __future__ import annotations

import dataclasses

from repro_torch.config import (ExperimentConfig, MeshConfig, ModelConfig,
                                OL4ELConfig, TrainConfig)


def experiment(model: ModelConfig, *, train: TrainConfig | None = None,
               ol4el: OL4ELConfig | None = None,
               notes: str = "") -> ExperimentConfig:
    return ExperimentConfig(
        model=model,
        train=train or TrainConfig(),
        ol4el=ol4el or OL4ELConfig(),
        mesh=MeshConfig(),
        notes=notes,
    )


def reduce_for_smoke(model: ModelConfig, **overrides) -> ModelConfig:
    """Shrink a full config to the CPU smoke-test contract.

    Same family / same flags, but: 2 layers, d_model<=512, <=4 experts,
    small vocab and short context so a forward+train step runs in seconds.
    """
    moe = model.moe
    if moe.enabled:
        moe = dataclasses.replace(
            moe,
            num_experts=min(moe.num_experts, 4),
            num_shared_experts=min(moe.num_shared_experts, 1),
            top_k=min(moe.top_k, 2),
            expert_ffn_dim=min(moe.expert_ffn_dim or 128, 128),
            shared_ffn_dim=min(moe.shared_ffn_dim or 128, 128),
        )
    d_model = min(model.d_model, 256)
    n_heads = min(model.n_heads, 4)
    n_kv = min(model.n_kv_heads, n_heads)
    if model.n_kv_heads == 1:
        n_kv = 1
    mamba = dataclasses.replace(
        model.mamba, head_dim=32, d_state=16, chunk_size=32)
    defaults = dict(
        n_layers=2,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=(64 if model.head_dim else 0),
        d_ff=min(model.d_ff, 512),
        vocab_size=min(model.vocab_size, 512),
        max_seq_len=256,
        moe=moe,
        mamba=mamba,
        num_prefix_embeddings=min(model.num_prefix_embeddings, 8),
        first_k_dense=min(model.first_k_dense, 1),
        sliding_window=min(model.sliding_window, 64) if model.sliding_window
        else 0,
        scan_layers=True,
        remat=False,
        name=model.name + "-smoke",
    )
    defaults.update(overrides)
    return dataclasses.replace(model, **defaults)


def smoke_experiment(full: ExperimentConfig, **overrides) -> ExperimentConfig:
    model = reduce_for_smoke(full.model, **overrides)
    train = dataclasses.replace(
        full.train, global_batch=2, seq_len=64, total_steps=4,
        warmup_steps=1)
    ol4el = dataclasses.replace(full.ol4el, n_edges=2, budget=500.0)
    return ExperimentConfig(model=model, train=train, ol4el=ol4el,
                            mesh=MeshConfig(shape=(1, 1)), notes=full.notes)

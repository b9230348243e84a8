"""Shared helper for the config files."""

from __future__ import annotations

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

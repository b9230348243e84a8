"""Model zoo of the port: the paper's classic models (the LM stack comes
in a later slice)."""

from __future__ import annotations

from repro_torch.config import ModelConfig
from repro_torch.models.classic import KMeans, LinearSVM


def build_model(cfg: ModelConfig, **kwargs):
    """ModelConfig -> model object (``device=`` and, for K-means,
    ``impl=`` pass through)."""
    if cfg.family != "classic":
        raise NotImplementedError(
            f"{cfg.name}: the LM stack arrives in a later slice of the port; "
            "this one builds the classic models only")
    if cfg.name.startswith("kmeans"):
        return KMeans(cfg, **kwargs)
    return LinearSVM(cfg, **kwargs)


__all__ = ["KMeans", "LinearSVM", "build_model"]

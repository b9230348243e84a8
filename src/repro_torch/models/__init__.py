"""Model zoo of the port: the unified LM (this slice: the pure-SSM stack)
plus the paper's classic models."""

from __future__ import annotations

from repro_torch.config import ModelConfig
from repro_torch.models.classic import KMeans, LinearSVM
from repro_torch.models.transformer import LM


def build_model(cfg: ModelConfig, **kwargs):
    """ModelConfig -> model object (``device=`` and, for K-means,
    ``impl=``, for the LM ``use_ssd_kernel=`` pass through)."""
    if cfg.family == "classic":
        if cfg.name.startswith("kmeans"):
            return KMeans(cfg, **kwargs)
        return LinearSVM(cfg, **kwargs)
    return LM(cfg, **kwargs)


__all__ = ["LM", "KMeans", "LinearSVM", "build_model"]

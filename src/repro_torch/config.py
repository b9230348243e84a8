"""Configuration for the port (a copy of ``repro.config``'s classic part).

Plain dataclasses, value-for-value equal to the reference's so a config
built here describes the same experiment:

  * ``ModelConfig``      -- the fields the classic models read
    (``d_model`` = feature dim, ``vocab_size`` = classes / clusters);
  * ``TrainConfig``      -- optimizer / schedule / batching;
  * ``OL4ELConfig``      -- the paper's scheduler knobs (arms, budgets, costs);
  * ``MeshConfig``       -- logical mesh description;
  * ``ExperimentConfig`` -- the bundle ``get_config(arch)`` returns.

Only the paper's two workloads (``CLASSIC_IDS``) resolve in this slice;
the LM architectures come with the LM-stack slice.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description (classic-model subset of the reference)."""

    name: str = "model"
    family: str = "dense"
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8
    d_ff: int = 2048
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    source: str = ""                     # provenance citation


@dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"             # adamw | sgd
    peak_lr: float = 3e-4
    min_lr_ratio: float = 0.1
    schedule: str = "cosine"             # cosine | wsd | constant
    warmup_steps: int = 100
    decay_start_frac: float = 0.8
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    momentum: float = 0.9
    grad_clip: float = 1.0
    opt_state_dtype: str = "float32"
    global_batch: int = 8
    seq_len: int = 512
    seed: int = 0
    z_loss: float = 0.0


@dataclass(frozen=True)
class OL4ELConfig:
    """Scheduler knobs — the paper's §IV parameters."""

    max_interval: int = 10               # arms = intervals {1..max_interval}
    mode: str = "async"                  # sync | async
    cost_model: str = "fixed"            # fixed | variable
    policy: str = "ol4el"                # a name in repro_torch.el.policies
    fixed_interval: int = 4              # for the Fixed-I baseline
    budget: float = 5000.0               # per-edge resource budget (units)
    comp_cost: float = 10.0              # base cost of one local iteration
    comm_cost: float = 50.0              # base cost of one global update
    heterogeneity: float = 1.0           # H = fastest/slowest speed ratio
    cost_noise: float = 0.0              # rel. std for variable-cost mode
    utility: str = "param_delta"         # param_delta | eval_gain | loss_delta
    async_alpha: float = 0.5             # async staleness-mix base rate
    async_batch_k: int = 0               # async wave width (compiled engine)
    ucb_c: float = 2.0                   # exploration constant
    eps: float = 0.1                     # for eps_greedy ablation
    n_edges: int = 4
    seed: int = 0
    scenario: Optional[Any] = None       # fleet dynamics (scenarios slice)


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")


@dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig
    train: TrainConfig = field(default_factory=TrainConfig)
    ol4el: OL4ELConfig = field(default_factory=OL4ELConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    notes: str = ""


# Paper-native workloads, the only ones this slice resolves.
CLASSIC_IDS: Tuple[str, ...] = ("svm-wafer", "kmeans-traffic")


def get_config(arch: str) -> ExperimentConfig:
    """Resolve an arch id to its full ExperimentConfig."""
    if arch not in CLASSIC_IDS:
        raise KeyError(f"unknown arch {arch!r}; this slice of the port "
                       f"resolves {CLASSIC_IDS}")
    module = "repro_torch.configs." + arch.replace("-", "_")
    return importlib.import_module(module).get_config()

"""Configuration for the port (a copy of ``repro.config``).

Plain dataclasses, field-for-field equal to the reference's so a config
built here describes the same experiment:

  * ``ModelConfig``      -- unified architecture description (with
    ``MoEConfig`` / ``MambaConfig``); the classic models read
    ``d_model`` as the feature dim, ``vocab_size`` as classes / clusters;
  * ``TrainConfig``      -- optimizer / schedule / batching;
  * ``OL4ELConfig``      -- the paper's scheduler knobs (arms, budgets, costs);
  * ``MeshConfig``       -- logical mesh description;
  * ``ExperimentConfig`` -- the bundle ``get_config(arch)`` returns.

The paper's two workloads (``CLASSIC_IDS``) and every LM architecture of
the reference (``PORTED_LM_IDS``) resolve; any other id raises a
``KeyError``.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


# Layer kinds understood by the unified decoder stack.
ATTN = "attn"
MAMBA = "mamba"

# FFN kinds.
DENSE_FFN = "dense"
MOE_FFN = "moe"
NO_FFN = "none"


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts sub-config (fine-grained, shared+routed)."""

    num_experts: int = 0                 # routed experts
    num_shared_experts: int = 0          # always-on experts (DeepSeekMoE)
    top_k: int = 2
    expert_ffn_dim: int = 0              # d_ff of each routed expert
    shared_ffn_dim: int = 0              # total d_ff of the shared experts
    capacity_factor: float = 1.25        # dispatch capacity multiplier
    router_aux_loss: float = 0.01        # load-balance loss weight
    router_z_loss: float = 1e-3          # router logit z-loss weight
    dispatch: str = "cumsum"             # cumsum | sort
    dispatch_groups: int = 0             # >1: group-local routing

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclass(frozen=True)
class MambaConfig:
    """Mamba2 / SSD sub-config."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 128                # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    """Unified architecture description (the reference's field set)."""

    name: str = "model"
    family: str = "dense"                # dense|moe|ssm|hybrid|vlm|audio|classic
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8                  # GQA; == n_heads -> MHA, 1 -> MQA
    d_ff: int = 2048
    head_dim: int = 0                    # 0 -> d_model // n_heads
    max_seq_len: int = 8192
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    qkv_bias: bool = False               # Qwen2.5-style QKV bias
    qk_norm: bool = False                # Qwen3-style per-head q/k RMSNorm
    tie_embeddings: bool = False
    act_fn: str = "silu"                 # silu (SwiGLU) | gelu (GeGLU)
    sliding_window: int = 0              # 0 = full causal attention
    # ATTN/MAMBA pattern tiled across n_layers; empty -> all ``attn``.
    layer_pattern: Tuple[str, ...] = ()
    # FFN pattern, tiled likewise; empty -> all DENSE_FFN (NO_FFN for
    # pure-ssm models with d_ff == 0).
    ffn_pattern: Tuple[str, ...] = ()
    moe: MoEConfig = field(default_factory=MoEConfig)
    mamba: MambaConfig = field(default_factory=MambaConfig)
    # prefix embedding positions that arrive pre-computed (e.g. patches)
    num_prefix_embeddings: int = 0
    # audio codebooks: >1 means input ids [B, n_codebooks, S]
    n_codebooks: int = 1
    # first-k layers replace MoE with a dense FFN
    first_k_dense: int = 0
    dtype: str = "bfloat16"
    remat: bool = True                   # activation checkpoint each layer
    scan_layers: bool = True             # stack params over layer groups
    source: str = ""                     # provenance citation

    # -- derived ----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind list of length n_layers."""
        if not self.layer_pattern:
            return tuple([ATTN] * self.n_layers)
        reps = -(-self.n_layers // len(self.layer_pattern))
        return tuple((self.layer_pattern * reps)[: self.n_layers])

    def ffn_kinds(self) -> Tuple[str, ...]:
        if not self.ffn_pattern:
            base = NO_FFN if self.d_ff == 0 and not self.moe.enabled else (
                MOE_FFN if self.moe.enabled else DENSE_FFN)
            kinds = [base] * self.n_layers
        else:
            reps = -(-self.n_layers // len(self.ffn_pattern))
            kinds = list((self.ffn_pattern * reps)[: self.n_layers])
        for i in range(min(self.first_k_dense, self.n_layers)):
            if kinds[i] == MOE_FFN:
                kinds[i] = DENSE_FFN
        return tuple(kinds)

    def block_pattern(self) -> Tuple[Tuple[str, str], ...]:
        """(layer_kind, ffn_kind) pairs, one per layer."""
        return tuple(zip(self.layer_kinds(), self.ffn_kinds()))

    def num_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, V = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        total = V * d                                    # embeddings
        if not self.tie_embeddings:
            total += d * V * self.n_codebooks            # lm head(s)
        for kind, ffn in self.block_pattern():
            total += d                                    # pre-norm scale
            if kind == ATTN:
                total += d * self.n_heads * hd            # q
                total += 2 * d * self.n_kv_heads * hd     # k, v
                total += self.n_heads * hd * d            # o
                if self.qkv_bias:
                    total += (self.n_heads + 2 * self.n_kv_heads) * hd
            else:  # mamba
                di = self.mamba.d_inner(d)
                nh = self.mamba.n_heads(d)
                ds = self.mamba.d_state
                total += d * (2 * di + 2 * ds + nh)       # in_proj (x,z,B,C,dt)
                total += self.mamba.d_conv * (di + 2 * ds)  # conv
                total += nh * 2 + di                      # A_log, D, dt_bias-ish
                total += di * d                           # out_proj
                total += di                               # gated norm
            if ffn != NO_FFN:
                total += d                                # post-norm scale
            if ffn == DENSE_FFN:
                total += 3 * d * self.d_ff                # gate/up/down
            elif ffn == MOE_FFN:
                m = self.moe
                total += d * m.num_experts                # router
                total += m.num_experts * 3 * d * m.expert_ffn_dim
                if m.num_shared_experts:
                    total += 3 * d * m.shared_ffn_dim
        total += d                                        # final norm
        return total


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


# Paper-native workloads.
CLASSIC_IDS: Tuple[str, ...] = ("svm-wafer", "kmeans-traffic")

# LM architectures of the reference: every one is ported.  ``LM_SLICES``
# would name the slice of the port that brings an LM id not ported yet
# (such an id raises naming it); it is empty.
PORTED_LM_IDS: Tuple[str, ...] = ("mamba2-370m", "qwen3-1.7b", "minicpm-2b",
                                   "qwen2.5-14b", "deepseek-coder-33b",
                                   "olmoe-1b-7b", "deepseek-moe-16b",
                                   "musicgen-medium", "paligemma-3b",
                                   "jamba-1.5-large-398b")
LM_SLICES: dict = {}


def _module_for(arch: str) -> str:
    if arch in LM_SLICES:
        raise KeyError(f"{arch!r} is not ported yet: it comes with "
                       f"{LM_SLICES[arch]} of the port")
    if arch not in CLASSIC_IDS + PORTED_LM_IDS:
        raise KeyError(f"unknown arch {arch!r}; the port resolves "
                       f"{CLASSIC_IDS + PORTED_LM_IDS}")
    return "repro_torch.configs." + arch.replace("-", "_").replace(".", "_")


def get_config(arch: str) -> ExperimentConfig:
    """Resolve an arch id to its full ExperimentConfig."""
    return importlib.import_module(_module_for(arch)).get_config()


def get_smoke_config(arch: str) -> ExperimentConfig:
    """Reduced variant of the same family for CPU smoke tests."""
    return importlib.import_module(_module_for(arch)).get_smoke_config()

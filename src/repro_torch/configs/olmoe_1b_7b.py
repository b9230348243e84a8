"""olmoe-1b-7b [moe] — 64 experts top-8 [arXiv:2409.02060].

16L d_model=2048 16H (GQA kv=16 == MHA) expert d_ff=1024 vocab=50304,
MoE 64e top-8, no shared experts, every layer MoE.
"""

from repro_torch.config import MoEConfig, ModelConfig
from repro_torch.configs._base import experiment, smoke_experiment


def get_config():
    model = ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        vocab_size=50304,
        d_model=2048,
        n_layers=16,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1024,
        qk_norm=True,                  # OLMoE uses QK-norm
        moe=MoEConfig(
            num_experts=64,
            top_k=8,
            expert_ffn_dim=1024,
            capacity_factor=1.25,
            router_aux_loss=0.01,
        ),
        max_seq_len=4096,
        source="arXiv:2409.02060 (OLMoE)",
    )
    return experiment(model)


def get_smoke_config():
    return smoke_experiment(get_config())

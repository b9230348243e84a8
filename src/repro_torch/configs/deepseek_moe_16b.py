"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6, fine-grained
[arXiv:2401.06066].

28L d_model=2048 16H (GQA kv=16 == MHA) expert d_ff=1408 vocab=102400,
MoE 64e top-6.  Layer 0 uses a dense FFN (DeepSeekMoE design).
"""

from repro_torch.config import MoEConfig, ModelConfig
from repro_torch.configs._base import experiment, smoke_experiment


def get_config():
    model = ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        vocab_size=102400,
        d_model=2048,
        n_layers=28,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,                     # assigned d_ff (fine-grained expert dim)
        moe=MoEConfig(
            num_experts=64,
            num_shared_experts=2,
            top_k=6,
            expert_ffn_dim=1408,
            shared_ffn_dim=2 * 1408,   # 2 shared experts of the same grain
            capacity_factor=1.25,
            router_aux_loss=0.01,
        ),
        first_k_dense=1,               # first layer dense (paper design)
        max_seq_len=32768,
        source="arXiv:2401.06066 (DeepSeekMoE)",
    )
    return experiment(model, notes="expert-parallel: 64 experts / 16 chips")


def get_smoke_config():
    return smoke_experiment(get_config())

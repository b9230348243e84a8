"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE
[arXiv:2403.19887].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Repeating 8-layer block with one attention layer (position 4), MoE on every
other layer (odd positions) — the Jamba block design.
"""

from repro_torch.config import (ATTN, DENSE_FFN, MAMBA, MOE_FFN,
                                MambaConfig, MoEConfig, ModelConfig)
from repro_torch.configs._base import experiment, smoke_experiment


def get_config():
    # Jamba block: [m, m, m, m, a, m, m, m]; FFN alternates dense / MoE.
    layer_pattern = (MAMBA, MAMBA, MAMBA, MAMBA, ATTN, MAMBA, MAMBA, MAMBA)
    ffn_pattern = (DENSE_FFN, MOE_FFN) * 4
    model = ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        vocab_size=65536,
        d_model=8192,
        n_layers=72,
        n_heads=64,
        n_kv_heads=8,
        d_ff=24576,
        layer_pattern=layer_pattern,
        ffn_pattern=ffn_pattern,
        moe=MoEConfig(
            num_experts=16,
            top_k=2,
            expert_ffn_dim=24576,
            capacity_factor=1.25,
            router_aux_loss=0.01,
        ),
        mamba=MambaConfig(d_state=128, d_conv=4, expand=2, head_dim=128,
                          chunk_size=128),
        max_seq_len=524288,
        source="arXiv:2403.19887 (Jamba) / Jamba-1.5 model card",
    )
    return experiment(
        model,
        notes="hybrid: 9 attn layers of 72; long_500k native (SSM majority, "
              "attention KV sharded over edge axes)")


def get_smoke_config():
    # Keep the hybrid character: one mamba + one attn layer, MoE on layer 1.
    cfg = get_config()
    return smoke_experiment(
        cfg,
        layer_pattern=(MAMBA, ATTN),
        ffn_pattern=(DENSE_FFN, MOE_FFN),
        n_layers=2,
    )

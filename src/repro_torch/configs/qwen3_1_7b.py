"""qwen3-1.7b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B family].

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936, head_dim=128.
"""

from repro_torch.config import ModelConfig
from repro_torch.configs._base import experiment, smoke_experiment


def get_config():
    model = ModelConfig(
        name="qwen3-1.7b",
        family="dense",
        vocab_size=151936,
        d_model=2048,
        n_layers=28,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,                  # Qwen3 fixes head_dim at 128
        d_ff=6144,
        qk_norm=True,                  # Qwen3 per-head q/k RMSNorm
        tie_embeddings=True,
        rope_theta=1000000.0,
        max_seq_len=32768,
        source="hf:Qwen/Qwen3-8B model card (family config, 1.7B scale)",
    )
    return experiment(model)


def get_smoke_config():
    return smoke_experiment(get_config())

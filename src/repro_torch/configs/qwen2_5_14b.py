"""qwen2.5-14b [dense] — GQA, QKV bias [hf:Qwen/Qwen2.5-0.5B family].

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.
"""

from repro_torch.config import ModelConfig
from repro_torch.configs._base import experiment, smoke_experiment


def get_config():
    model = ModelConfig(
        name="qwen2.5-14b",
        family="dense",
        vocab_size=152064,
        d_model=5120,
        n_layers=48,
        n_heads=40,
        n_kv_heads=8,
        d_ff=13824,
        qkv_bias=True,                 # Qwen2.5 uses attention QKV bias
        rope_theta=1000000.0,
        max_seq_len=131072,
        source="hf:Qwen/Qwen2.5-0.5B model card (family config, 14B scale)",
    )
    return experiment(model)


def get_smoke_config():
    return smoke_experiment(get_config())

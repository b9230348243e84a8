"""deepseek-coder-33b [dense] — llama-arch [arXiv:2401.14196].

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256.
"""

from repro_torch.config import ModelConfig
from repro_torch.configs._base import experiment, smoke_experiment


def get_config():
    model = ModelConfig(
        name="deepseek-coder-33b",
        family="dense",
        vocab_size=32256,
        d_model=7168,
        n_layers=62,
        n_heads=56,
        n_kv_heads=8,
        d_ff=19200,
        rope_theta=100000.0,
        max_seq_len=16384,
        source="arXiv:2401.14196 (DeepSeek-Coder)",
    )
    return experiment(model)


def get_smoke_config():
    return smoke_experiment(get_config())

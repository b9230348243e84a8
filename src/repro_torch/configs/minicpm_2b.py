"""minicpm-2b [dense] — WSD schedule, llama-like arch [arXiv:2404.06395].

40L d_model=2304 36H (GQA kv=36 == MHA) d_ff=5760 vocab=122753.
"""

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.configs._base import experiment, smoke_experiment


def get_config():
    model = ModelConfig(
        name="minicpm-2b",
        family="dense",
        vocab_size=122753,
        d_model=2304,
        n_layers=40,
        n_heads=36,
        n_kv_heads=36,
        d_ff=5760,
        tie_embeddings=True,           # MiniCPM ties input/output embeddings
        max_seq_len=32768,
        source="arXiv:2404.06395 (MiniCPM)",
    )
    # The paper's signature Warmup-Stable-Decay schedule.
    train = TrainConfig(schedule="wsd", decay_start_frac=0.9,
                        warmup_steps=100)
    return experiment(model, train=train,
                      notes="WSD schedule exercised by train substrate")


def get_smoke_config():
    return smoke_experiment(get_config())

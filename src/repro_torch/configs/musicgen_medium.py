"""musicgen-medium [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284].

48L d_model=1536 24H (GQA kv=24 == MHA) d_ff=6144 vocab=2048.
4 EnCodec codebooks: input ids [B, 4, S] (embeddings summed), 4 LM heads.
The conv/EnCodec frontend is a stub — ``input_specs()`` provides token ids
directly (the backbone is the deliverable per the assignment carve-out).
"""

from repro_torch.config import ModelConfig
from repro_torch.configs._base import experiment, smoke_experiment


def get_config():
    model = ModelConfig(
        name="musicgen-medium",
        family="audio",
        vocab_size=2048,
        d_model=1536,
        n_layers=48,
        n_heads=24,
        n_kv_heads=24,
        d_ff=6144,
        n_codebooks=4,
        act_fn="gelu",
        max_seq_len=32768,
        source="arXiv:2306.05284 (MusicGen)",
    )
    return experiment(model, notes="audio backbone; EnCodec frontend stubbed")


def get_smoke_config():
    return smoke_experiment(get_config())

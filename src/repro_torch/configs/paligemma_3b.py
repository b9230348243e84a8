"""paligemma-3b [vlm] — SigLIP + gemma decoder [arXiv:2407.07726].

18L d_model=2048 8H (GQA kv=1 == MQA) d_ff=16384 vocab=257216.
Gemma-style: head_dim=256, GeGLU MLP.  The SigLIP vision tower + projector
is a stub — ``input_specs()`` provides 256 precomputed patch embeddings per
image which are prepended to the text tokens (assignment carve-out).
"""

from repro_torch.config import ModelConfig
from repro_torch.configs._base import experiment, smoke_experiment


def get_config():
    model = ModelConfig(
        name="paligemma-3b",
        family="vlm",
        vocab_size=257216,
        d_model=2048,
        n_layers=18,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,                  # gemma: head_dim != d_model/n_heads
        d_ff=16384,
        act_fn="gelu",
        tie_embeddings=True,           # gemma ties embeddings
        num_prefix_embeddings=256,     # SigLIP 224px -> 256 patches
        max_seq_len=8192,
        source="arXiv:2407.07726 (PaliGemma)",
    )
    return experiment(model, notes="vision frontend stubbed per assignment")


def get_smoke_config():
    return smoke_experiment(get_config())

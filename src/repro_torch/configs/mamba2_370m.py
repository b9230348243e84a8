"""mamba2-370m [ssm] — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=1024, attention-free, d_ff=0, vocab=50280, ssm_state=128.
Mamba2-370m uses expand=2 (d_inner=2048), head_dim=64 -> 32 SSD heads.
"""

from repro_torch.config import MAMBA, MambaConfig, ModelConfig
from repro_torch.configs._base import experiment, smoke_experiment


def get_config():
    model = ModelConfig(
        name="mamba2-370m",
        family="ssm",
        vocab_size=50280,
        d_model=1024,
        n_layers=48,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,                       # attn-free, no separate FFN block
        layer_pattern=(MAMBA,),
        mamba=MambaConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                          chunk_size=128),
        tie_embeddings=True,          # GPT-NeoX tokenizer family ties embs
        max_seq_len=524288,           # SSM: unbounded context, state is O(1)
        source="arXiv:2405.21060 (Transformers are SSMs: SSD / Mamba-2)",
    )
    return experiment(model, notes="pure-SSM arch; long_500k runs natively")


def get_smoke_config():
    return smoke_experiment(get_config())

"""kmeans-traffic [classic] — the paper's own unsupervised workload (§V.A).

K-means (K=3) over features of 20,000 traffic surveillance images.
``family="classic"``: d_model = feature dim, vocab_size = K clusters.
The paper does not state the feature dimension; 64-d image features are
assumed, as in the reference config.
"""

from repro_torch.config import ModelConfig, OL4ELConfig, TrainConfig
from repro_torch.configs._base import experiment, smoke_experiment


def get_config():
    model = ModelConfig(
        name="kmeans-traffic",
        family="classic",
        d_model=64,                    # feature dimension (assumed)
        vocab_size=3,                  # K = 3 clusters (paper)
        n_layers=1,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        dtype="float32",
        scan_layers=False,
        remat=False,
        source="OL4EL paper §V.A (YouTube Live traffic images, K=3)",
    )
    train = TrainConfig(optimizer="sgd", peak_lr=1.0, schedule="constant",
                        global_batch=256, total_steps=500, weight_decay=0.0,
                        grad_clip=0.0)
    ol4el = OL4ELConfig(budget=5000.0, comp_cost=10.0, comm_cost=50.0,
                        max_interval=10, utility="param_delta")
    return experiment(model, train=train, ol4el=ol4el,
                      notes="paper-native unsupervised task")


def get_smoke_config():
    return smoke_experiment(get_config(), d_model=16, vocab_size=3,
                            n_layers=1, n_heads=0, n_kv_heads=0, d_ff=0)

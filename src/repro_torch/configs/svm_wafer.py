"""svm-wafer [classic] — the paper's own supervised workload (§V.A).

Multiclass (one-vs-rest) linear SVM over 59-dimensional wafer-image
features, 8 classes, 20,000 samples.  ``family="classic"`` models reuse
ModelConfig fields: d_model = feature dim, vocab_size = number of classes.
"""

from repro_torch.config import ModelConfig, OL4ELConfig, TrainConfig
from repro_torch.configs._base import experiment, smoke_experiment


def get_config():
    model = ModelConfig(
        name="svm-wafer",
        family="classic",
        d_model=59,                    # feature dimension (paper: 59)
        vocab_size=8,                  # classes (paper: 8)
        n_layers=1,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        dtype="float32",
        scan_layers=False,
        remat=False,
        source="OL4EL paper §V.A (wafer images, smart manufacturing)",
    )
    train = TrainConfig(optimizer="sgd", peak_lr=0.05, schedule="constant",
                        global_batch=64, total_steps=2000, weight_decay=1e-4,
                        grad_clip=0.0)
    ol4el = OL4ELConfig(budget=5000.0, comp_cost=10.0, comm_cost=50.0,
                        max_interval=10, utility="eval_gain")
    return experiment(model, train=train, ol4el=ol4el,
                      notes="paper-native supervised task")


def get_smoke_config():
    return smoke_experiment(get_config(), d_model=59, vocab_size=8,
                            n_layers=1, n_heads=0, n_kv_heads=0, d_ff=0)

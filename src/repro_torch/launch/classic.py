"""The shared classic-workload (SVM / K-means) EL data plane.

``classic_fixture`` builds the per-arch fixture the port's launchers use:
dataset → Dirichlet edge split → ``ClassicExecutor`` on the device, plus
the arch's recipe constants (the reference's ``CLASSIC_RECIPES``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.config import get_config
from repro_torch.data import (make_traffic_dataset, make_wafer_dataset,
                              partition_edges)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.federated import ClassicExecutor
from repro_torch.models import build_model

#: Per-arch data-plane recipe: (metric, lr, batch, utility).  The
#: utility matches the paper's pairing — eval-gain for the SVM testbed,
#: the model-specific param-delta for K-means.
CLASSIC_RECIPES = {
    "svm-wafer": ("accuracy", 0.05, 64, "eval_gain"),
    "kmeans-traffic": ("f1", 1.0, 128, "param_delta"),
}


def classic_fixture(arch: str, *, samples: int, n_edges: int,
                    alpha: float = 100.0, data_seed: int = 0,
                    kmeans_impl: Optional[str] = None,
                    batch: Optional[int] = None,
                    lr: Optional[float] = None,
                    device: DeviceLike = None) -> Dict[str, Any]:
    """Build the classic EL data plane on ``device`` (default CUDA).

    ``kmeans_impl=None`` picks the E-step from the device: the CUDA kernel
    on a CUDA device, the plain torch version on the CPU.  Returns a dict
    with ``exp`` (the ExperimentConfig), ``model``, ``executor``,
    ``metric``, ``lr``, ``utility``, ``init_params`` (from
    ``model.init`` on a generator seeded with ``data_seed``) and
    ``n_samples`` (per-edge sizes, the aggregation weights).  ``batch``
    and ``lr`` override the recipe's minibatch size and learning rate.
    """
    dev = resolve_device(device)
    metric, recipe_lr, recipe_batch, utility = CLASSIC_RECIPES[arch]
    lr = recipe_lr if lr is None else lr
    exp = get_config(arch)
    if arch == "kmeans-traffic":
        impl = kmeans_impl or ("cuda" if dev.type == "cuda" else "torch")
        train, test = make_traffic_dataset(n=samples, seed=data_seed)
        model = build_model(exp.model, impl=impl, device=dev)
    else:
        train, test = make_wafer_dataset(n=samples, seed=data_seed)
        model = build_model(exp.model, device=dev)
    edges = partition_edges(train, n_edges, alpha=alpha, seed=data_seed)
    ex = ClassicExecutor(model, edges, test, batch=batch or recipe_batch,
                         lr=lr, device=dev)
    return {
        "exp": exp, "model": model, "executor": ex, "metric": metric,
        "lr": lr, "utility": utility,
        "init_params": model.init(torch.Generator().manual_seed(data_seed)),
        "n_samples": [len(e["y"]) for e in edges],
    }

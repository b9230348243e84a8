"""The paper's own workloads in PyTorch: linear SVM and K-means.

Both expose the functional surface the EL runtime drives:
  ``init(generator) -> params``
  ``local_step(params, batch, lr) -> (params, metrics)``  (one local iteration)
  ``step(params, batch, lr) -> params``  (the same update, no metrics: the
      reference's jitted scan drops the unused metrics as dead code, eager
      PyTorch would run them, so the executors call this)
  ``evaluate(params, eval_set) -> metrics``               (cloud-side utility)

``scores``, ``step``, ``local_step`` and K-means' ``assign`` also take a
leading edge dimension: batches ``[E, B, D]`` against per-edge params
(``w`` ``[E, D, C]``, ``centers`` ``[E, K, D]``), each edge stepping its
own copy.  That is the reference's ``jax.vmap`` over edges in the
compiled EL round (``repro_torch.el.ingraph``), written out.

Params are a ``dict[str, Tensor]``, not an ``nn.Module``: the EL runtime
copies a global model to every edge, trains the copies apart and averages
or mixes them leaf by leaf (``repro_torch.federated.aggregation``).  A
plain dict is that pytree — functional updates return new dicts, so an
edge's copy never aliases the global model, and the JAX reference's params
carry across one to one (``repro_torch.interop``).

SVM  — multiclass one-vs-rest squared-hinge linear SVM (paper: 59-dim wafer
       features, 8 classes; metric = prediction accuracy).
K-means — minibatch Lloyd steps (paper: traffic images, K=3; metric = F1
       of cluster assignments vs. ground truth after greedy cluster->class
       matching; utility = negative center shift between slots).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.kmeans_assign import ops as ka_ops
from repro_torch.kernels.kmeans_assign.ref import assign_ref

Params = Dict[str, torch.Tensor]


def correct_count(scores: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Rows whose argmax is the label, an f32 tensor (exact)."""
    return (scores.argmax(-1) == y).sum(-1).float()


def accuracy_tensor(scores: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Share of rows whose argmax is the label, as an f32 0-dim tensor on
    the scores' device (no host sync), rounded as the reference's f32
    ``mean`` rounds it: the exact count times the f32 reciprocal of the
    row count (XLA's mean multiplies; a division differs by an ulp for
    some counts, and the bandit's utility is this value's delta)."""
    return correct_count(scores, y) * float(np.float32(1)
                                            / np.float32(y.shape[-1]))


def _accuracy(scores: torch.Tensor, y: torch.Tensor) -> float:
    return float(accuracy_tensor(scores, y))


# ---------------------------------------------------------------------------
# Linear multiclass SVM (one-vs-rest, squared hinge)
# ---------------------------------------------------------------------------


class LinearSVM:
    def __init__(self, cfg: ModelConfig, reg: float = 1e-4,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.d = cfg.d_model
        self.n_classes = cfg.vocab_size
        self.reg = reg
        self.device = resolve_device(device)

    def init(self, generator: torch.Generator) -> Params:
        return {
            "w": torch.zeros(self.d, self.n_classes, device=self.device),
            "b": torch.zeros(self.n_classes, device=self.device),
        }

    def scores(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """[B, C], or [E, B, C] for per-edge params and batches."""
        return x @ params["w"] + params["b"].unsqueeze(-2)

    def _margins(self, params: Params, x: torch.Tensor, y: torch.Tensor):
        """Scores, ±1 one-vs-rest targets and squared-hinge margins."""
        s = self.scores(params, x)                                # [B, C]
        classes = torch.arange(self.n_classes, device=y.device)
        y_pm = (y[..., None] == classes).float() * 2.0 - 1.0    # [B, C] ±1
        return s, y_pm, torch.clamp(1.0 - y_pm * s, min=0.0)

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        x, y = batch["x"], batch["y"]
        s, _, margin = self._margins(params, x, y)
        loss = ((margin ** 2).sum(-1).mean(-1)
                + self.reg * (params["w"] ** 2).sum((-2, -1)))
        acc = (s.argmax(-1) == y).float().mean(-1)
        return loss, {"loss": loss, "accuracy": acc}

    def step(self, params: Params, batch: Dict[str, torch.Tensor],
             lr: float) -> Params:
        """One SGD step on the squared hinge + L2, gradients in closed form:
        dL/ds = -2 y± max(0, 1 - y± s) / B, dw = xᵀ dL/ds + 2 reg w,
        db = Σ_B dL/ds.  Computes no metrics (the executors' hot path).
        With a leading edge dim the products are batched (``bmm``)."""
        x = batch["x"]
        _, y_pm, margin = self._margins(params, x, batch["y"])
        g_s = (-2.0 / x.shape[-2]) * (y_pm * margin)              # [B, C]
        g_w = x.transpose(-1, -2) @ g_s + (2.0 * self.reg) * params["w"]
        return {"w": params["w"] - lr * g_w,
                "b": params["b"] - lr * g_s.sum(-2)}

    def local_step(self, params: Params, batch: Dict[str, torch.Tensor],
                   lr: float) -> Tuple[Params, Dict[str, torch.Tensor]]:
        """``step`` plus the batch's loss and accuracy before the step."""
        return self.step(params, batch, lr), self.loss(params, batch)[1]

    def evaluate(self, params: Params, eval_set: Dict[str, torch.Tensor]
                 ) -> Dict[str, float]:
        s = self.scores(params, eval_set["x"])
        return {"accuracy": _accuracy(s, eval_set["y"])}


# ---------------------------------------------------------------------------
# K-means (minibatch Lloyd)
# ---------------------------------------------------------------------------


class KMeans:
    """Minibatch-Lloyd K-means.

    ``impl`` selects the E-step: ``"torch"`` (the plain distance expansion,
    ``kernels.kmeans_assign.ref``) or ``"cuda"`` — the hand-written Hopper
    kernel through its wrapper, one launch per call: the single entry for
    ``[B, D]``, the batched entry for ``[E, B, D]`` against per-edge
    centres.  ``"cuda"`` refuses CPU tensors rather than quietly running
    the plain version.
    """

    def __init__(self, cfg: ModelConfig, blend: float = 0.5,
                 impl: str = "torch", device: DeviceLike = None):
        if impl not in ("torch", "cuda"):
            raise ValueError(f"KMeans impl={impl!r}; expected 'torch' or "
                             "'cuda'")
        self.cfg = cfg
        self.d = cfg.d_model
        self.k = cfg.vocab_size
        self.blend = blend           # minibatch-Lloyd blending rate
        self.impl = impl
        self.device = resolve_device(device)

    def init(self, generator: torch.Generator) -> Params:
        """Standard-normal centres from ``generator`` (a CPU generator, so
        a seed gives the same centres on every device)."""
        c = torch.randn(self.k, self.d, generator=generator)
        return {"centers": c.to(self.device)}

    def assign(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """[B] assignments, or [E, B] for per-edge centres [E, K, D]."""
        if self.impl == "cuda":
            if x.device.type != "cuda":
                raise ValueError(
                    "KMeans(impl='cuda') runs the CUDA kernel and got "
                    f"tensors on {x.device}; use impl='torch' on the CPU")
            if x.dim() == 3:
                return ka_ops.assign_with_dist_batched(
                    x, params["centers"])[0]
            return ka_ops.assign(x, params["centers"])
        return assign_ref(x, params["centers"])[0]

    def inertia(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return assign_ref(x, params["centers"])[1].mean(-1)

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        loss = self.inertia(params, batch["x"])
        return loss, {"loss": loss}

    def step(self, params: Params, batch: Dict[str, torch.Tensor],
             lr: float = 1.0) -> Params:
        """One minibatch Lloyd step (blend new centroids into old).
        Computes no metrics: the E-step is the only distance computation."""
        x = batch["x"]
        c = params["centers"]
        a = self.assign(params, x)                                # [B]
        clusters = torch.arange(self.k, device=x.device)
        onehot = (a[..., None] == clusters).float()               # [B, K]
        counts = onehot.sum(-2)                                   # [K]
        new = ((onehot.transpose(-1, -2) @ x)
               / torch.clamp(counts[..., None], min=1.0))
        # the reference computes rate in f32: blend * f32(lr)
        rate = float(np.float32(self.blend) * np.float32(lr))
        centers = torch.where((counts > 0)[..., None],
                              (1.0 - rate) * c + rate * new, c)
        return {"centers": centers}

    def local_step(self, params: Params, batch: Dict[str, torch.Tensor],
                   lr: float = 1.0) -> Tuple[Params, Dict[str, torch.Tensor]]:
        """``step`` plus the batch's inertia under the new centres."""
        new = self.step(params, batch, lr)
        return new, {"loss": self.inertia(new, batch["x"])}

    def evaluate(self, params: Params, eval_set: Dict[str, torch.Tensor]
                 ) -> Dict[str, float]:
        """Macro F1 after greedy cluster->class matching (paper metric)."""
        x = eval_set["x"]
        a = self.assign(params, x).cpu().numpy()
        y = eval_set["y"].cpu().numpy()
        return {"f1": cluster_f1(a, y, self.k),
                "inertia": float(self.inertia(params, x).item())}


def cluster_f1(assignments: np.ndarray, labels: np.ndarray, k: int) -> float:
    """Greedy majority cluster->class mapping, then macro F1."""
    n_classes = int(labels.max()) + 1
    mapping = np.zeros(k, np.int64)
    for c in range(k):
        members = labels[assignments == c]
        mapping[c] = np.bincount(members, minlength=n_classes).argmax() \
            if members.size else 0
    pred = mapping[assignments]
    f1s = []
    for cls in range(n_classes):
        tp = np.sum((pred == cls) & (labels == cls))
        fp = np.sum((pred == cls) & (labels != cls))
        fn = np.sum((pred != cls) & (labels == cls))
        prec = tp / max(tp + fp, 1)
        rec = tp / max(tp + fn, 1)
        f1s.append(0.0 if prec + rec == 0 else 2 * prec * rec / (prec + rec))
    return float(np.mean(f1s))

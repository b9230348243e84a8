"""The typed edge data-plane interface the EL runtime drives.

``EdgeExecutor`` is the ``local_train/evaluate`` surface as an explicit,
runtime-checkable Protocol; ``repro_torch.federated.ClassicExecutor``
satisfies it structurally.  ``InGraphExecutor`` is the narrower contract
the compiled device programs will need (raw per-edge arrays + the model),
kept here for the slice that brings them.
"""

from __future__ import annotations

from typing import (Any, Dict, List, Protocol, Tuple, runtime_checkable)

import numpy as np

Params = Any


@runtime_checkable
class EdgeExecutor(Protocol):
    """One edge server's training/eval surface.

    ``local_train`` runs ``n_iters`` local iterations for ``edge`` starting
    from ``params`` and returns the updated params plus an info dict;
    ``evaluate`` computes cloud-side metrics (the utility estimator and the
    report both read them).
    """

    def local_train(self, params: Params, edge: int, n_iters: int,
                    seed: int) -> Tuple[Params, Dict]:
        ...

    def evaluate(self, params: Params) -> Dict[str, float]:
        ...


@runtime_checkable
class InitCapable(Protocol):
    """Executors that can produce their own initial parameters."""

    def init_params(self, seed: int) -> Params:
        ...


@runtime_checkable
class InGraphExecutor(Protocol):
    """The model plus raw per-edge datasets, so a whole budgeted loop can
    run on the device."""

    model: Any
    edge_data: List[Dict[str, np.ndarray]]
    eval_set: Dict[str, Any]
    batch: int
    lr: float

    def local_train(self, params: Params, edge: int, n_iters: int,
                    seed: int) -> Tuple[Params, Dict]:
        ...

    def evaluate(self, params: Params) -> Dict[str, float]:
        ...


def validate_executor(ex: Any) -> None:
    """Fail fast (with a useful message) on malformed executors."""
    missing = [m for m in ("local_train", "evaluate")
               if not callable(getattr(ex, m, None))]
    if missing:
        raise TypeError(
            f"{type(ex).__name__} does not satisfy EdgeExecutor: "
            f"missing callable(s) {missing}; see repro_torch.el.executor")

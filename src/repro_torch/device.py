"""Device resolution for every ``repro_torch`` entry point.

The port runs on the card unless the caller asks for the CPU: ``None``
resolves to ``cuda`` and, when CUDA is absent, raises rather than falling
back.  Tests and the CPU parity runs pass ``device="cpu"``.

Resolving a CUDA device also turns TF32 off for matmuls and cuDNN
(``torch.backends.cuda.matmul.allow_tf32`` / ``cudnn.allow_tf32``): the
K-means argmin and the bandit's decisions flip under TF32 rounding, and
the parity tiers assume full f32 products.  This is the one place the
port sets them.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass device=\"cpu\" to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev

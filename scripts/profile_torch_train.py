#!/usr/bin/env python3
"""Where the card's time goes when the PyTorch port trains qwen3-1.7b.

    PYTHONPATH=src python scripts/profile_torch_train.py

Builds the full-width model, its AdamW state and a batch on the card as
``repro_torch.launch.train.train_standard`` does (random weights from a
generator seeded with the experiment's ``train.seed``; B = 8, S = 512, the
experiment's own batch), warms up with one train step, then profiles one
step in its two halves, each under ``torch.profiler`` with the card
synchronised around it: ``loss_and_grads`` (forward, remat recompute and
backward) and ``apply_updates`` (clip and AdamW).  Prints one JSON line
per half with the fields of ``profile_torch_serve.py`` (wall, device busy,
idle share, kernel count, top kernels) plus ``categories``: device time by
kind of kernel, then the card's name and power limit (nvidia-smi).  Fails
when there is no card or the profiler reports no device time.
"""

from __future__ import annotations

import json
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from profile_torch_serve import device_events, profile_phase  # noqa: E402

# kernel-name substrings, first match wins
CATEGORIES = (("flash_attention", ("flash_attention_kernel",)),
              ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
              ("softmax", ("softmax",)),
              ("reduce", ("reduce",)),
              ("copy_cast", ("copy", "cast")),
              ("elementwise", ("elementwise", "vectorized")))


def categorise(prof) -> dict:
    out = defaultdict(float)
    for e in device_events(prof):
        name = e.name.lower()
        kind = next((k for k, subs in CATEGORIES
                     if any(s in name for s in subs)), "other")
        out[kind] += (e.time_range.end - e.time_range.start) / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")

    from repro_torch.config import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import build_model
    from repro_torch.train import apply_updates, init_train_state, \
        make_train_step
    from repro_torch.train.state import loss_and_grads

    exp = get_config("qwen3-1.7b")
    cfg, tc = exp.model, exp.train
    model = build_model(cfg, device="cuda")
    state = init_train_state(
        model, tc, torch.Generator(device="cuda").manual_seed(tc.seed))
    data = SyntheticLMData.for_model(cfg, tc.global_batch, tc.seq_len)
    state, _ = make_train_step(model, tc)(
        state, data.batch(0, 0, device="cuda"))          # warm-up
    batch = data.batch(0, 1, device="cuda")
    held = {}

    def forward_backward():
        held["metrics"], held["grads"] = loss_and_grads(model, state.params,
                                                        batch)

    def optimizer():
        apply_updates(tc, state.params, held["grads"], state.opt)

    for name, fn in (("loss_and_grads", forward_backward),
                     ("apply_updates", optimizer)):
        out, prof = profile_phase(name, fn)
        out.update(categories=categorise(prof), batch=tc.global_batch,
                   seq=tc.seq_len, card=torch.cuda.get_device_name(0))
        print(json.dumps(out), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()

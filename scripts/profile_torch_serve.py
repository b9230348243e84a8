#!/usr/bin/env python3
"""Where the card's time goes when the PyTorch port serves mamba2-370m.

    PYTHONPATH=src python scripts/profile_torch_serve.py

Builds the full-width model and its prompts on the card as
``chip_smoke.py``'s serve phase does (``repro_torch.launch.serve.build``:
random weights from a seeded generator), at the serving prefill's shape
(4 prompts of 512 tokens), warms up once, then runs one prefill and 8
decode steps, each phase under ``torch.profiler`` with the card
synchronised around it.  Prints one JSON line per phase:

  wall_ms        host clock around the phase;
  device_ms      union of the intervals in which a kernel ran (CUPTI);
  idle_share     1 - device_ms / wall_ms;
  kernels        launches seen by the profiler;
  top            the kernels with the most device time, with their count.

then the card's name and power limit (nvidia-smi).  Fails when there is no
card or the profiler reports no device time.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

BATCH, PROMPT_LEN, DECODE_STEPS = 4, 512, 8


def device_events(prof):
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events() if e.device_type == cuda]


def busy_ms(events) -> float:
    """Length of the union of the events' [start, end) intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3                        # profiler times are in us


def profile_phase(name: str, fn):
    """Run ``fn`` under the profiler, the card synchronised around it;
    returns the phase's summary and the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    if not events:
        raise SystemExit(f"{name}: the profiler saw no device time")
    per_name = defaultdict(lambda: [0, 0.0])
    for e in events:
        per_name[e.name][0] += 1
        per_name[e.name][1] += (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:12]
    dev = busy_ms(events)
    return {"phase": name, "wall_ms": wall, "device_ms": dev,
            "idle_share": 1.0 - dev / wall, "kernels": len(events),
            "top": [{"name": n[:120], "count": c, "ms": ms}
                    for n, (c, ms) in top]}, prof


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")

    from repro_torch.config import get_config
    from repro_torch.launch.serve import build

    cfg = get_config("mamba2-370m").model
    model, params, prompts = build(cfg, BATCH, PROMPT_LEN, "cuda")
    state = {}

    def prefill():
        logits, state["cache"] = model.prefill(
            params, prompts, model.init_cache(BATCH, 0))
        state["tok"] = logits[:, -1].argmax(-1, keepdim=True)

    def decode():
        for _ in range(DECODE_STEPS):
            logits, state["cache"] = model.decode_step(
                params, state["tok"], state["cache"])
            state["tok"] = logits[:, -1].argmax(-1, keepdim=True)

    with torch.inference_mode():
        prefill()                              # warm-up: build, cuBLAS
        decode()
        for name, fn in (("prefill", prefill), ("decode", decode)):
            out, _ = profile_phase(name, fn)
            out.update(batch=BATCH, prompt_len=PROMPT_LEN,
                       steps=1 if name == "prefill" else DECODE_STEPS,
                       card=torch.cuda.get_device_name(0))
            print(json.dumps(out), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()

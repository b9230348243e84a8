"""Perf hillclimb (port of ``scripts/perf_hillclimb.py``): plan the
optimization variants of the three chosen pairs on one H100 and emit
before/after roofline terms.

Each variant is a (flags, tag) combination run through
``repro_torch.launch.dryrun`` in this process (the planner traces on
``meta`` tensors; no device count is locked at import, so no subprocess is
needed).  Rows append to ``results/torch_dryrun_opt.jsonl`` with distinct
tags; calibration twins (tagged calib1/calib2 within the same file and
tag) feed ``repro_torch.bench.roofline``'s extrapolation per variant.
The ``el_round`` variants plan one rank's share of the OL4EL round
(``dryrun --step el_round``, ``repro_torch.federated.local_sgd``); a
variant whose state does not fit one card writes its row with ``fits:
false``.

Usage: PYTHONPATH=src python -m repro_torch.bench.hillclimb [--only N]
"""

from __future__ import annotations

import argparse

from repro_torch.launch import dryrun

OUT = "results/torch_dryrun_opt.jsonl"

# (arch, shape, extra dryrun args, tag)
VARIANTS = [
    # -- pair 1: qwen3-1.7b x train_4k ------------------------------------
    # paper-faithful EL round (the technique itself), interval ~4
    ("qwen3-1.7b", "train_4k", ["--step", "el_round", "--h-max", "4"],
     "el_round_h4"),
    # larger interval: fewer aggregations per round
    ("qwen3-1.7b", "train_4k", ["--step", "el_round", "--h-max", "8"],
     "el_round_h8"),
    # beyond-paper: cross-entropy as logsumexp less the label logit
    ("qwen3-1.7b", "train_4k", ["--fused-xent"], "fused_xent"),
    # beyond-paper: no activation checkpointing (flops down, memory up)
    ("qwen3-1.7b", "train_4k", ["--no-remat"], "no_remat"),
    # combined
    ("qwen3-1.7b", "train_4k", ["--fused-xent", "--no-remat"],
     "fused_xent_no_remat"),
    # -- pair 2: deepseek-moe-16b x prefill_32k ---------------------------
    # beyond-paper: sort-based MoE dispatch (O(Tk) vs O(TkE) bookkeeping)
    ("deepseek-moe-16b", "prefill_32k", ["--moe-sort-dispatch"],
     "moe_sort"),
    # beyond-paper: serving prefill emits last-position logits only
    ("deepseek-moe-16b", "prefill_32k", ["--prefill-last-only"],
     "prefill_last"),
    ("deepseek-moe-16b", "prefill_32k",
     ["--moe-sort-dispatch", "--prefill-last-only"], "moe_sort_last"),
    # -- pair 3: qwen2.5-14b x long_500k ----------------------------------
    # beyond-paper: windowed KV slice decode (O(window) cache reads)
    ("qwen2.5-14b", "long_500k", ["--window-slice"], "window_slice"),
]


def run_variant(arch, shape, args, tag, calibrate=True, out=OUT):
    base = ["--arch", arch, "--shape", shape, "--out", out,
            "--skip-existing"]
    if tag:
        base += ["--tag", tag]
    cmds = [base + args]
    if calibrate and "--step" not in args:
        cmds.append(base + args + ["--calibrate"])
    for cmd in cmds:
        print(">>", " ".join(cmd), flush=True)
        if dryrun.main(cmd):
            print(f"!! variant failed: {tag}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", type=int, default=None,
                    help="run a single variant index")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    for i, (arch, shape, extra, tag) in enumerate(VARIANTS):
        if args.only is not None and i != args.only:
            continue
        run_variant(arch, shape, extra, tag, out=args.out)


if __name__ == "__main__":
    main()

"""Roofline analysis of the planner's rows on one H100 (port of
``benchmarks/roofline.py``).

Reads the JSONL rows that ``repro_torch.launch.dryrun`` writes and
derives, per (arch x shape x mesh x step):

    compute term    = FLOPs      / 989e12 bf16 FLOP/s (tensor cores, dense)
    memory term     = bytes      / 3.35e12 HBM B/s
    collective term = coll_bytes / 450e9 NVLink B/s (one direction)

A row's counts are one card's: the whole step (``mesh`` 1x1, no
collective), or rank 0's share of it on a mesh (``el_round`` rows, and
``--mesh pod|multipod``'s 16x16 / 2x16x16 rows), whose ``collectives``
(the reference's schema: ``per_op`` and ``bytes_per_device``, each
all-gather metered by its gathered result) all go at NVLink's rate: the
inter-node link of a 256- or 512-card mesh is not modelled.
MODEL_FLOPS uses 6*N_active*tokens for training, 2*N_active*tokens for
forward-only steps, with the row's ``batch`` / ``seq_len`` where the
planner overrode the shape's; the ratio MODEL_FLOPS / (counted FLOPs x
``n_chips``) exposes remat, recompute and dispatch waste, and on a mesh
the model axis's redundant compute (each of its ranks runs its rows'
whole step on gathered weights).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, Iterable, List, Optional

# NVIDIA H100 SXM (one card), NVIDIA's data sheet: dense rates without
# sparsity, at the full 700 W power limit.
PEAK_FLOPS = 989e12          # bf16 on the tensor cores
F32_FLOPS = 67e12            # f32 outside the tensor cores
HBM_BW = 3.35e12             # HBM3 bytes/s
NVLINK_BW = 450e9            # NVLink 4 bytes/s, one direction
# The data sheet's 80 GB of HBM3 ("NVIDIA H100 80GB HBM3" in nvidia-smi);
# the planner's ``fits`` holds a predicted peak to it.
CARD_NAME = "NVIDIA H100 80GB HBM3"
CARD_MEMORY_BYTES = 80 * 10 ** 9

SUGGESTIONS = {
    "compute": ("increase arithmetic efficiency: larger per-card batch, "
                "reduce remat recompute, or shrink the useful-FLOPs gap"),
    "memory": ("cut HBM traffic: fuse elementwise chains, keep weights "
               "resident (bigger blocks), or drop precision of cached "
               "tensors"),
    "collective": ("cut collective volume: shard params over more axes "
                   "(fewer all-gathers), aggregate less often (larger OL4EL "
                   "interval), or overlap collectives with compute"),
}


def load_records(paths: Iterable[str]) -> List[Dict[str, Any]]:
    rows = []
    for path in paths:
        if not os.path.exists(path):
            continue
        with open(path) as f:
            for line in f:
                try:
                    rows.append(json.loads(line))
                except json.JSONDecodeError:
                    pass
    return rows


def model_flops(rec: Dict[str, Any]) -> float:
    from repro_torch.config import INPUT_SHAPES
    n_active = rec.get("active_params", 0)
    s = INPUT_SHAPES[rec["shape"]]
    batch = rec.get("batch", s.global_batch)
    seq_len = rec.get("seq_len", s.seq_len)
    if s.kind == "train":
        tokens = batch * seq_len
        mult = 6.0
        if rec.get("step") == "el_round":
            tokens *= rec.get("h_max", 1)
    elif s.kind == "prefill":
        tokens = batch * seq_len
        mult = 2.0
    else:  # decode: one token per sequence
        tokens = batch
        mult = 2.0
    return mult * n_active * tokens


def _extract(rec: Dict[str, Any]):
    cost = rec.get("cost", {})
    return (cost.get("flops", 0.0), cost.get("bytes accessed", 0.0),
            rec.get("collectives", {}).get("bytes_per_device", 0.0))


def calibration_index(records: List[Dict[str, Any]]) -> Dict:
    """(arch, shape, mesh, step, tag) -> depth-extrapolated (flops,
    bytes, coll) from the 2-point calibration rows (``calib1`` /
    ``calib2``): ``total = c1 + (n_groups - 1) * (c2 - c1)``.  The
    planner's eager trace counts every layer, so for it the extrapolation
    reproduces the full-depth count."""
    pairs: Dict = {}
    for rec in records:
        tag = rec.get("tag", "")
        if not rec.get("ok") or "calib" not in tag:
            continue
        base, _, cal = tag.rpartition("calib")
        base = base.rstrip("|")
        key = (rec["arch"], rec["shape"], rec["mesh"], rec.get("step"),
               base)
        pairs.setdefault(key, {})["calib" + cal] = rec
    out = {}
    for key, d in pairs.items():
        if "calib1" not in d or "calib2" not in d:
            continue
        c1 = _extract(d["calib1"])
        c2 = _extract(d["calib2"])
        n = d["calib1"].get("n_groups_full") or 1
        out[key] = tuple(a + (n - 1) * (b - a) for a, b in zip(c1, c2))
    return out


def analyze(rec: Dict[str, Any],
            calib: Optional[Dict] = None) -> Optional[Dict[str, Any]]:
    if not rec.get("ok") or "calib" in rec.get("tag", ""):
        return None
    flops_dev, bytes_dev, coll_dev = _extract(rec)
    calibrated = False
    if calib:
        key = (rec["arch"], rec["shape"], rec["mesh"], rec.get("step"),
               rec.get("tag", ""))
        if key in calib:
            flops_dev, bytes_dev, coll_dev = calib[key]
            calibrated = True
    coll = rec.get("collectives", {})
    chips = rec.get("n_chips", 1)
    t_compute = flops_dev / PEAK_FLOPS
    t_memory = bytes_dev / HBM_BW
    t_coll = coll_dev / NVLINK_BW
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops(rec)
    hlo_flops_global = flops_dev * chips
    useful = mf / hlo_flops_global if hlo_flops_global else float("nan")
    bound = max(terms.values())
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "step": rec.get("step"), "tag": rec.get("tag", ""),
        "calibrated": calibrated,
        "chips": chips,
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "bound_s": bound,
        "model_flops": mf,
        "hlo_flops_global": hlo_flops_global,
        "useful_flops_ratio": useful,
        "suggestion": SUGGESTIONS[dominant],
        "collectives": coll.get("per_op", {}),
        "memory_bytes_per_dev": rec.get("memory", {}),
    }


def markdown_table(rows: List[Dict[str, Any]]) -> str:
    hdr = ("| arch | shape | mesh | step | compute s | memory s | "
           "collective s | dominant | useful FLOPs |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['step']} | "
            f"{r['t_compute_s']:.3e} | {r['t_memory_s']:.3e} | "
            f"{r['t_collective_s']:.3e} | **{r['dominant']}** | "
            f"{r['useful_flops_ratio']:.2f} |")
    return hdr + "\n".join(lines) + "\n"


def run(paths: Optional[List[str]] = None, quiet: bool = False
        ) -> List[Dict[str, Any]]:
    """Analyze the planner's rows (default: ``results/torch_dryrun*.jsonl``
    and ``results/torch_calib*.jsonl``; never the reference's TPU rows)."""
    paths = paths or sorted(glob.glob("results/torch_dryrun*.jsonl")
                            + glob.glob("results/torch_calib*.jsonl"))
    records = load_records(paths)
    calib = calibration_index(records)
    rows = []
    for rec in records:
        a = analyze(rec, calib)
        if a:
            rows.append(a)
    if not quiet:
        for r in rows:
            print(f"roofline {r['arch']:22s} {r['shape']:12s} {r['mesh']:8s} "
                  f"{r['step']:12s} dom={r['dominant']:10s} "
                  f"bound={r['bound_s']:.3e}s useful={r['useful_flops_ratio']:.2f}",
                  flush=True)
    return rows


if __name__ == "__main__":
    import sys
    rows = run(sys.argv[1:] or None)
    print(markdown_table(rows))

"""A/B of the K-means assignment kernel against another commit's build.

    python scripts/kmeans_tiles_ab.py --parent DIR [--rounds 5]

Builds ``src/repro_torch/csrc/kmeans_assign.cu`` of this checkout and of
DIR (a checkout of another commit, e.g. unpacked by ``git archive``) with
the same nvcc flags, checks that the two give bit-identical assignments
and distances at phase 8's shapes (all K centres in one block, where the
tiled kernel runs one tile), and times both in turns (parent, change,
change, parent, each round) by CUDA events on one card.  Prints one JSON
line per shape, then the card's name and power limit.  Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

# (edges, n, d, k): phase 8's single entry at the local step, Fig. 5's
# minibatch, the evaluation set and the microbenchmark; the batched entry
# at 4b's 4 edges, a rank's 2 and the sweep's 96 (cell, edge) pairs
SHAPES = [(1, 128, 64, 3), (1, 32, 64, 3), (1, 4000, 64, 3),
          (1, 4096, 64, 3), (4, 128, 64, 3), (2, 128, 64, 3),
          (96, 128, 64, 3)]


def build(source: Path, out: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"build of {source} failed:\n{proc.stderr}")
    return ctypes.CDLL(str(out))


def launcher(lib: ctypes.CDLL, tiled: bool):
    """The library's entry point as f(x, c, out_a, out_d2, group): the
    tiled build takes the centres a tile (all K here) after K."""
    import torch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = lib.kmeans_assign_launch
    fn.argtypes = [vp, vp] + [ci] * (7 if tiled else 6) + [vp, vp, vp]
    fn.restype = ci

    def launch(x, c, out_a, out_d2, group):
        e, n, d = x.shape
        k = c.shape[1]
        sizes = (e, n, d, k, k) if tiled else (e, n, d, k)
        err = fn(x.data_ptr(), c.data_ptr(), *sizes, 0, group,
                 out_a.data_ptr(), out_d2.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"launch failed: CUDA error {err}")
    return launch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, type=Path,
                    help="a checkout of the commit to compare against")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    import torch
    from chip_smoke import card_line, cuda_ms
    from repro_torch.device import resolve_device
    from repro_torch.kernels.kmeans_assign import kernel
    resolve_device("cuda")
    rel = Path("src/repro_torch/csrc/kmeans_assign.cu")
    out_dir = ROOT / "build" / "kmeans_ab"
    builds = {}
    for name, base in (("parent", args.parent), ("change", ROOT)):
        src = base / rel
        tiled = "int k, int kt," in src.read_text()
        builds[name] = launcher(build(src, out_dir / f"{name}.so"), tiled)
    g = torch.Generator(device="cuda").manual_seed(0)
    for e, n, d, k in SHAPES:
        x = torch.randn(e, n, d, generator=g, device="cuda")
        c = torch.randn(e, k, d, generator=g, device="cuda")
        group = kernel.lane_group(d)
        outs = {}
        for name, launch in builds.items():
            outs[name] = (torch.empty(e, n, dtype=torch.int32,
                                      device="cuda"),
                          torch.empty(e, n, device="cuda"))
            launch(x, c, *outs[name], group)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(outs["parent"],
                                                      outs["change"]))
        times = {"parent": [], "change": []}
        for _ in range(args.rounds):
            for name in ("parent", "change", "change", "parent"):
                times[name].append(cuda_ms(
                    lambda: builds[name](x, c, *outs[name], group),
                    queued=True))
        med = {name: statistics.median(t) for name, t in times.items()}
        print(json.dumps({"e": e, "n": n, "d": d, "k": k,
                          "bit_equal": same, "parent_ms": times["parent"],
                          "change_ms": times["change"],
                          "parent_median_ms": med["parent"],
                          "change_median_ms": med["change"],
                          "change_over_parent": med["change"] / med["parent"]
                          }), flush=True)
        if not same:
            raise SystemExit(f"outputs differ at {(e, n, d, k)}")
    print(card_line(), flush=True)


if __name__ == "__main__":
    main()

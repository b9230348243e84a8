"""nvcc seconds of the port's kernels, this checkout's beside another's.

    python scripts/build_seconds.py --parent DIR [--rounds 1]

Builds every library of the sources under ``src/repro_torch/csrc/`` of DIR
(a checkout of another commit, e.g. unpacked by ``git archive``) and of
this checkout as ``chip_smoke.py``'s build phase does: one nvcc per
library with the port's flags, all of a checkout's at once (a source that
tests ``F16_INSTANCES`` builds twice, without and with
``-DF16_INSTANCES``).  The checkouts take turns
(parent, change, change, parent, each round), never at the same time.
Prints one JSON line per build (each library's seconds, and the wall
seconds of the checkout's parallel build, which is what the build phase
waits for), then the card's name and power limit.  Needs nvcc; the card
only for its name.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def build_tree(base: Path, out_dir: Path) -> dict:
    from repro_torch.kernels import _build
    libs = []
    for src in sorted((base / "src/repro_torch/csrc").glob("*.cu")):
        libs.append((src.stem, src, ()))
        if "F16_INSTANCES" in src.read_text():
            libs.append((src.stem + "_f16", src, ("-DF16_INSTANCES",)))
    out_dir.mkdir(parents=True, exist_ok=True)

    def one(lib) -> float:
        name, src, defines = lib
        t = time.perf_counter()
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-o",
               str(out_dir / f"lib{name}.so"), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"build of {name} failed:\n{proc.stderr}")
        return time.perf_counter() - t

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        seconds = dict(zip((name for name, _, _ in libs),
                           pool.map(one, libs)))
    return {"wall_s": time.perf_counter() - t0, "nvcc_s": seconds}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, type=Path,
                    help="a checkout of the commit to compare against")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    from chip_smoke import card_line
    out_dir = ROOT / "build" / "build_seconds"
    for r in range(args.rounds):
        for name in ("parent", "change", "change", "parent"):
            base = args.parent if name == "parent" else ROOT
            row = build_tree(base, out_dir / name)
            print(json.dumps({"round": r, "tree": name, **row}), flush=True)
    print(card_line(), flush=True)


if __name__ == "__main__":
    main()

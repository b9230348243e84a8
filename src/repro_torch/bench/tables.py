"""The planner's data tables (port of ``scripts/make_experiments_tables.py``).

Usage: PYTHONPATH=src python -m repro_torch.bench.tables
Reads the port's planner rows (``results/torch_dryrun.jsonl``,
``torch_calib.jsonl``, ``torch_dryrun_el.jsonl``,
``torch_dryrun_opt.jsonl``; never the reference's TPU rows) and writes
markdown fragments to ``results/tables/torch_*.md`` and the roofline rows
to ``results/tables/torch_roofline.json``.
"""

from __future__ import annotations

import json
import os
from collections import Counter, OrderedDict

from repro_torch.bench import roofline

SOURCES = ("results/torch_dryrun.jsonl", "results/torch_calib.jsonl",
           "results/torch_dryrun_el.jsonl", "results/torch_dryrun_opt.jsonl")


def dedupe(rows):
    seen = OrderedDict()
    for r in rows:
        key = (r["arch"], r["shape"], r["mesh"], r.get("step"),
               r.get("tag", ""))
        seen[key] = r          # last write wins
    return list(seen.values())


def fmt_bytes(b):
    return f"{b / 2**30:.2f}"


def dryrun_table(rows) -> str:
    hdr = ("| arch | shape | mesh | step | args GiB | temps GiB | "
           "peak GiB | fits | flops | coll MB | plan s |\n"
           + "|---|" * 11 + "\n")
    lines = []
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if not r.get("ok"):
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"{r.get('step')} | FAIL: {r.get('error')} "
                         "| | | | | | |")
            continue
        mem = r.get("memory", {})
        cost = r.get("cost", {})
        coll = r.get("collectives", {}).get("bytes_per_device", 0)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['step']} | "
            f"{fmt_bytes(mem.get('argument_size_in_bytes', 0))} | "
            f"{fmt_bytes(mem.get('temp_size_in_bytes', 0))} | "
            f"{fmt_bytes(mem.get('peak_live_bytes', 0))} | "
            f"{'yes' if r.get('fits') else 'no'} | "
            f"{cost.get('flops', 0):.3e} | {coll / 2**20:.1f} | "
            f"{r.get('plan_s', 0):.0f} |")
    return hdr + "\n".join(lines) + "\n"


def main():
    os.makedirs("results/tables", exist_ok=True)
    all_rows = []
    for f in SOURCES:
        all_rows += roofline.load_records([f])
    rows = dedupe(all_rows)
    calib = roofline.calibration_index(rows)
    main_rows = [r for r in rows if not r.get("tag", "").startswith("calib")]
    ok = [r for r in main_rows if r.get("ok")]
    print(f"{len(main_rows)} unique main combos ({len(calib)} calibrated), "
          f"{len(main_rows) - len(ok)} failures")

    with open("results/tables/torch_dryrun.md", "w") as f:
        f.write(dryrun_table(main_rows))

    roof = []
    for r in ok:
        a = roofline.analyze(r, calib)
        if a:
            roof.append(a)
    roof.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"], r["step"]))
    with open("results/tables/torch_roofline.md", "w") as f:
        f.write(roofline.markdown_table(roof))
    with open("results/tables/torch_roofline.json", "w") as f:
        json.dump(roof, f, indent=1, default=str)

    # dominant-term summary, one card and rank 0 of each production mesh
    for mesh, what in (("1x1", "one H100"), ("16x16", "rank 0 of 16x16"),
                       ("2x16x16", "rank 0 of 2x16x16")):
        doms = Counter((r["shape"], r["dominant"]) for r in roof
                       if r["mesh"] == mesh and r["step"] != "el_round")
        if not doms:
            continue
        print(f"dominant terms ({what}):")
        for (shape, dom), n in sorted(doms.items()):
            print(f"  {shape:12s} {dom:10s} x{n}")


if __name__ == "__main__":
    main()

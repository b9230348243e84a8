"""The port's figure harness: ``python -m repro_torch.bench.run``.

One benchmark per paper artifact (Fig. 3/4/5) plus the policy ablation,
the roofline analysis over the planner's rows
(``repro_torch.bench.roofline``: ``results/torch_dryrun*.jsonl``, H100
constants) and the microbenchmarks (``repro_torch.bench.microbench``), on
the card unless ``--device`` says otherwise.  Writes the reference's JSON
keys to ``--out`` and prints the harness CSV contract
``name,us_per_call,derived`` at the end, the micro rows first, with the
reference's row names, and the roofline rows last
(``roofline:arch:shape:mesh:step``, the bound in microseconds, the
dominant term).

Modes (the reference's sizes):
  --fast   tiny sizes (CI smoke)
  default  reduced-but-representative sizes
  --full   paper-scale (20k samples, H sweep to 15, 100 edges)

"""

from __future__ import annotations

import argparse
import json
import os
import time

def sizes(fast: bool = False, full: bool = False):
    """The (fig3, fig4, fig5) keyword sets of a preset."""
    if fast:
        kw3 = dict(budget=1200.0, n_data=2000, seeds=(0,),
                   h_values=[1.0, 6.0, 15.0])
        kw4 = dict(budget=1200.0, n_data=2000, seeds=(0,))
        kw5 = dict(budget=400.0, n_data=2000, seeds=(0,),
                   edge_counts=[3, 10], h_values=[1.0, 15.0])
    elif full:
        kw3 = dict(budget=5000.0, n_data=20000, seeds=(0, 1, 2))
        kw4 = dict(budget=5000.0, n_data=20000, seeds=(0, 1, 2))
        kw5 = dict(budget=600.0, n_data=20000, seeds=(0, 1),
                   edge_counts=[3, 10, 30, 100])
    else:
        kw3 = dict(budget=3000.0, n_data=8000, seeds=(0, 1),
                   h_values=[1.0, 3.0, 6.0, 9.0, 15.0])
        kw4 = dict(budget=3000.0, n_data=8000, seeds=(0, 1))
        kw5 = dict(budget=600.0, n_data=8000, seeds=(0, 1),
                   edge_counts=[3, 10, 30], h_values=[1.0, 5.0, 15.0])
    return kw3, kw4, kw5


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--only", default=None,
                    choices=[None, "fig3", "fig4", "fig5", "roofline",
                             "micro", "policies"])
    ap.add_argument("--out", default="results/torch_bench.json")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    kw3, kw4, kw5 = sizes(args.fast, args.full)
    dev = dict(device=args.device)

    all_rows = []
    t_start = time.time()

    if args.only in (None, "fig3"):
        from repro_torch.bench import fig3_heterogeneity
        all_rows += fig3_heterogeneity.run(**kw3, **dev)
    if args.only in (None, "fig4"):
        from repro_torch.bench import fig4_tradeoff
        all_rows += fig4_tradeoff.run(**kw4, **dev)
    if args.only in (None, "fig5"):
        from repro_torch.bench import fig5_scalability
        all_rows += fig5_scalability.run(**kw5, **dev)
    if args.only in (None, "policies"):
        from repro_torch.bench import policy_ablation
        pol_seeds = (0,) if args.fast else (0, 1, 2)
        all_rows += [dict(r, metric=r.get("svm_acc", r["oracle_frac"]))
                     for r in policy_ablation.run(
                         seeds=pol_seeds, with_testbed=not args.fast,
                         **dev)]
    roofline_rows = []
    if args.only in (None, "roofline"):
        from repro_torch.bench import roofline
        roofline_rows = roofline.run()
    micro_rows = []
    if args.only in (None, "micro"):
        from repro_torch.bench import microbench
        micro_rows = microbench.run(**dev)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"figures": all_rows, "roofline": roofline_rows,
                   "micro": micro_rows,
                   "wall_s": time.time() - t_start}, f, indent=1,
                  default=str)

    # harness CSV contract: name,us_per_call,derived
    print("\nname,us_per_call,derived")
    for r in micro_rows:
        print(f"{r['name']},{r['us_per_call']:.1f},{r['derived']}")
    for r in all_rows:
        name = ":".join(str(r.get(k)) for k in
                        ("figure", "workload", "algo", "H", "n_edges",
                         "consumption_frac") if r.get(k) is not None)
        print(f"{name},0,{r['metric']:.4f}")
    for r in roofline_rows:
        name = f"roofline:{r['arch']}:{r['shape']}:{r['mesh']}:{r['step']}"
        print(f"{name},{r['bound_s'] * 1e6:.2f},{r['dominant']}")
    print(f"# total wall time: {time.time() - t_start:.1f}s")


if __name__ == "__main__":
    main()

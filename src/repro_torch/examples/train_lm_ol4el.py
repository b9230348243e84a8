"""End to end: train a ~100M-parameter LM with the OL4EL
edge-cloud loop — the paper's technique applied to LM pretraining (port
of ``examples/train_lm_ol4el.py``).

Simulated heterogeneous edges, per-block global-update intervals chosen
by the budget-limited bandit, local-SGD blocks with staleness-aware
merging, budget accounting, and checkpointing (the reference's ``.npz``
format) — all through the ``repro_torch.el.ELSession`` façade, on the
card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm_ol4el \
        --preset 100m --rounds 100         # the full run
    PYTHONPATH=src python -m repro_torch.examples.train_lm_ol4el \
        --preset 25m --rounds 60           # a short evidence run
"""

import argparse
import time

from repro_torch.config import ModelConfig, OL4ELConfig, TrainConfig
from repro_torch.device import resolve_device
from repro_torch.el import ELSession
from repro_torch.federated import LMExecutor
from repro_torch.models import build_model
from repro_torch.train import checkpoint

PRESETS = {
    # ~100M params: 12L x 640d, llama-like, 32k vocab
    "100m": ModelConfig(name="lm-100m", vocab_size=32768, d_model=640,
                        n_layers=12, n_heads=10, n_kv_heads=10, d_ff=1720,
                        dtype="float32", remat=False),
    # ~25M
    "25m": ModelConfig(name="lm-25m", vocab_size=16384, d_model=384,
                       n_layers=8, n_heads=6, n_kv_heads=6, d_ff=1024,
                       dtype="float32", remat=False),
    # ~5M: smoke
    "5m": ModelConfig(name="lm-5m", vocab_size=4096, d_model=192,
                      n_layers=4, n_heads=4, n_kv_heads=4, d_ff=512,
                      dtype="float32", remat=False),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="100m", choices=list(PRESETS))
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--edges", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--heterogeneity", type=float, default=4.0)
    ap.add_argument("--budget", type=float, default=50_000.0)
    ap.add_argument("--max-interval", type=int, default=6)
    ap.add_argument("--policy", default="ol4el")
    ap.add_argument("--ckpt", default="results/torch_lm_ol4el.npz")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, required)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    mc = PRESETS[args.preset]
    print(f"model={mc.name} params={mc.num_params() / 1e6:.1f}M "
          f"edges={args.edges} H={args.heterogeneity} device={dev}")
    tc = TrainConfig(optimizer="adamw", peak_lr=3e-4, schedule="cosine",
                     warmup_steps=20, total_steps=args.rounds * 3,
                     global_batch=args.batch, seq_len=args.seq)
    ol = OL4ELConfig(max_interval=args.max_interval, mode="async",
                     policy=args.policy, budget=args.budget,
                     comp_cost=10.0, comm_cost=40.0,
                     heterogeneity=args.heterogeneity, n_edges=args.edges,
                     utility="loss_delta")

    model = build_model(mc, device=dev)
    ex = LMExecutor(model, mc, tc, batch=args.batch, seq_len=args.seq)

    t_start = time.time()

    def progress(rec):
        if rec.n_aggregations % 10 == 0:
            print(f"event {rec.n_aggregations:4d} loss={rec.metric:.4f} "
                  f"edge={rec.edge} interval={rec.interval:.0f} "
                  f"consumed={rec.total_consumed:.0f} "
                  f"({time.time() - t_start:.0f}s)", flush=True)

    session = (ELSession(ol, metric_name="loss", lr=tc.peak_lr)
               .with_executor(ex)
               .with_policy(args.policy)
               .on_round(progress))
    report = session.run(max_events=args.rounds * args.edges)

    print(f"done: {report.n_aggregations} aggregations, final loss "
          f"{report.final_metric:.4f}, consumed "
          f"{report.total_consumed:.0f}/{args.edges * args.budget:.0f} "
          f"({report.terminated_reason})")
    print("arm pull counts (interval 1..K):", report.arm_pulls)
    if args.ckpt:
        checkpoint.save(args.ckpt, report.final_params,
                        step=report.n_aggregations)
        print(f"saved checkpoint -> {args.ckpt}")
    return report


if __name__ == "__main__":
    main()

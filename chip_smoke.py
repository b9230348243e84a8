#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  -- require CUDA, turn TF32 off, report the card;
2. build   -- compile every kernel of the path from ``src/repro_torch/csrc``
              with nvcc for sm_90a (ptxas report included);
3. kernel  -- hold each kernel against its plain PyTorch version on the
              card, at the reference tests' shapes and the main path's;
4. slice   -- the paper's host EL loop at full width: kmeans-traffic
              (20,000 samples, 4 edges, batch 128, budget 5000 per edge)
              through ``ELSession.run_sync`` and ``run_async`` on the card,
              with every kernel's launch count read around that run; the
              same runs on the CPU with the plain E-step must make the
              same decisions; then svm-wafer sync at full width;
5. kernels -- per-kernel launches, error, times (CUDA events) and bound,
              beside the time of one empty launch.

Then the card's name and power limit (nvidia-smi), and last
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero, as
does a machine without CUDA or a directory without the repo's sources.
The script imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12           # f32 outside the tensor cores


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0 and out.stdout.strip() != "",
          f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 200, warmup: int = 20,
            queued: bool = False) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls, by CUDA events.

    ``queued=False`` times calls as a caller makes them, host enqueue
    included (a launch-bound call is host-bound).  ``queued=True`` first
    parks the stream on a ~0.1 s device sleep, so every launch is already
    enqueued when the card reaches the start event: the card then runs
    them back to back and the time is the device's alone.
    """
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 3: kernel vs plain ---------------------------------------------------

# (n, d, k, dtype name): the reference's kernel-test cases, then the main
# path's local-step minibatch and evaluation-set shapes.
KM_CASES = [(100, 8, 3, "float32"), (1000, 64, 3, "float32"),
            (513, 59, 8, "float32"), (256, 16, 32, "float32"),
            (300, 64, 3, "bfloat16"), (128, 64, 3, "float32"),
            (4000, 64, 3, "float32")]
MAIN_SHAPES = [(128, 64, 3), (4000, 64, 3)]


def km_inputs(n, d, k, dtype_name, seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    dtype = getattr(torch, dtype_name)
    x = torch.randn(n, d, generator=g).to("cuda", dtype)
    c = torch.randn(k, d, generator=g).to("cuda", dtype)
    return x, c


def kernel_vs_plain() -> float:
    """Returns the largest |d2 - d2_plain| at the main path's shapes."""
    import torch
    from repro_torch.kernels.kmeans_assign import ops, ref
    main_err = 0.0
    for i, (n, d, k, dt) in enumerate(KM_CASES):
        x, c = km_inputs(n, d, k, dt, seed=i)
        a, d2 = ops.assign_with_dist(x, c)
        a_ref, d2_ref = ref.assign_ref(x, c)
        torch.cuda.synchronize()
        # f32: the expansion cancels terms of size ||x||^2 ~ D, and the two
        # sides sum in different orders; bf16 inputs as the reference test
        tol = 1e-2 if dt == "bfloat16" else None
        rtol, atol = (tol, tol) if tol else (1e-4, 1e-3)
        err = float((d2 - d2_ref).abs().max())
        close = torch.allclose(d2, d2_ref, rtol=rtol, atol=atol)
        agree = float((a == a_ref).float().mean())
        emit("kernel_vs_plain", kernel="kmeans_assign", n=n, d=d, k=k,
             dtype=dt, max_abs_err=err, assign_agree=agree)
        check(close, f"kmeans_assign d2 off at {(n, d, k, dt)}: {err}")
        check(dt == "bfloat16" or agree >= 0.999,
              f"kmeans_assign assignments agree {agree} at {(n, d, k, dt)}")
        if (n, d, k) in MAIN_SHAPES:
            main_err = max(main_err, err)
    # an exact tie (duplicated centroid) must resolve to the lower index
    x, c = km_inputs(1000, 64, 3, "float32", seed=99)
    c[1] = c[0]
    a, _ = ops.assign_with_dist(x, c)
    a_ref, _ = ref.assign_ref(x, c)
    torch.cuda.synchronize()
    emit("kernel_vs_plain", kernel="kmeans_assign", case="tie",
         picked_duplicate=int((a == 1).sum()),
         assign_agree=float((a == a_ref).float().mean()))
    check(not bool((a == 1).any()), "kmeans_assign tie went to the higher "
          "index")
    check(bool((a == a_ref).all()), "kmeans_assign tie case disagrees")
    return main_err


# -- phase 4: the slice ----------------------------------------------------------

def f1_flip_bound(y) -> float:
    """Largest macro-F1 change one flipped prediction can make: it moves
    one unit of tp/fp/fn in two classes, each class's F1 by at most
    2 / support."""
    import numpy as np
    support = np.bincount(y)
    return 4.0 / (len(support) * float(support.min()))


def run_session(fx, mode: str, init):
    from repro_torch.el import ELSession
    cfg = dataclasses.replace(fx["exp"].ol4el, mode=mode, n_edges=4,
                              utility=fx["utility"])
    sess = (ELSession(cfg, metric_name=fx["metric"], lr=fx["lr"])
            .with_executor(fx["executor"], init_params=init,
                           n_samples=fx["n_samples"]))
    t0 = time.perf_counter()
    rep = sess.run()
    return rep, time.perf_counter() - t0


def decisions(rep):
    return [(r.interval, r.edge) for r in rep.records]


def slice_phase() -> dict:
    import math
    import torch
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.kernels.kmeans_assign import ops
    from repro_torch.launch.classic import classic_fixture

    gpu = classic_fixture("kmeans-traffic", samples=20000, n_edges=4,
                          device="cuda")
    check(gpu["model"].impl == "cuda", "kmeans on CUDA must use the kernel")
    init = params_to_numpy(gpu["init_params"])

    # the main path: every kernel count is read around exactly this run
    ops.launches = 0
    gpu_reports, per_mode = {}, {}
    for mode in ("sync", "async"):
        before = ops.launches
        rep, secs = run_session(gpu, mode, params_from_numpy(init, "cuda"))
        torch.cuda.synchronize()
        gpu_reports[mode] = (rep, secs)
        per_mode[mode] = ops.launches - before
        check(per_mode[mode] > 0, f"kmeans {mode}: kernel never launched")
    launches = ops.launches

    cpu = classic_fixture("kmeans-traffic", samples=20000, n_edges=4,
                          device="cpu")
    bound = f1_flip_bound(cpu["executor"].eval_set["y"].numpy())
    for mode in ("sync", "async"):
        rep, secs = gpu_reports[mode]
        ref, ref_secs = run_session(cpu, mode, params_from_numpy(init, "cpu"))
        same = decisions(rep) == decisions(ref)
        emit("slice", arch="kmeans-traffic", mode=mode, device="cuda",
             aggregations=rep.n_aggregations,
             consumed=rep.total_consumed, final_f1=rep.final_metric,
             arm_pulls=rep.arm_pulls, reason=rep.terminated_reason,
             run_s=secs, kernel_launches=per_mode[mode],
             cpu_final_f1=ref.final_metric, cpu_run_s=ref_secs,
             same_decisions=same, f1_flip_bound=bound)
        check(same, f"kmeans {mode}: CUDA and CPU decisions differ")
        check(rep.arm_pulls == ref.arm_pulls, f"kmeans {mode}: arm pulls")
        check(abs(rep.final_metric - ref.final_metric) <= bound,
              f"kmeans {mode}: final F1 {rep.final_metric} vs CPU "
              f"{ref.final_metric}")
        check(math.isfinite(rep.final_metric) and
              all(torch.isfinite(v).all() for v in rep.final_params.values()),
              f"kmeans {mode}: non-finite result")

    svm = classic_fixture("svm-wafer", samples=20000, n_edges=4,
                          device="cuda")
    rep, secs = run_session(svm, "sync", svm["init_params"])
    torch.cuda.synchronize()
    emit("slice", arch="svm-wafer", mode="sync", device="cuda",
         aggregations=rep.n_aggregations, consumed=rep.total_consumed,
         final_accuracy=rep.final_metric, arm_pulls=rep.arm_pulls,
         reason=rep.terminated_reason, run_s=secs)
    check(rep.n_aggregations > 0 and 0.5 < rep.final_metric <= 1.0,
          f"svm-wafer sync: accuracy {rep.final_metric}")
    return {"kmeans_assign": launches}


# -- phase 5: times and bounds ------------------------------------------------

def kmeans_timing(n: int, d: int, k: int) -> dict:
    import torch
    from repro_torch.kernels.kmeans_assign import ops, ref
    x, c = km_inputs(n, d, k, "float32", seed=7)
    nbytes = (n * d + k * d) * 4 + n * (4 + 4)
    flops = 2 * n * k * d + 2 * n * d + 2 * k * d + 3 * n * k
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    out = {"n": n, "d": d, "k": k}
    for key, fn in (("", lambda: ops.assign_with_dist(x, c)),
                    ("plain_", lambda: ref.assign_ref(x, c)),
                    ("library_", lambda: torch.cdist(x, c).min(-1))):
        out[key + "ms"] = cuda_ms(fn, queued=True)       # the card's time
        out[key + "call_ms"] = cuda_ms(fn)               # host enqueue incl.
    out.update(bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=nbytes, flops=flops)
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    from repro_torch.device import resolve_device
    resolve_device("cuda")                    # also turns TF32 off
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         tf32=torch.backends.cuda.matmul.allow_tf32)

    from repro_torch.kernels.kmeans_assign import kernel as ka_kernel
    t0 = time.perf_counter()
    lib_path = ka_kernel.library_path()
    ka_kernel.library()
    log = lib_path.with_suffix(".log").read_text() \
        if lib_path.with_suffix(".log").exists() else ""
    emit("build", kernel="kmeans_assign", seconds=time.perf_counter() - t0,
         library=str(lib_path.relative_to(ROOT)),
         ptxas=[ln.strip() for ln in log.splitlines() if "ptxas info" in ln])

    main_err = kernel_vs_plain()
    launches = slice_phase()

    shapes = [kmeans_timing(*s) for s in MAIN_SHAPES]
    step = shapes[0]
    # an empty kernel queued the same way: what a launch alone costs
    launch_floor_ms = cuda_ms(lambda: torch.cuda._sleep(0), queued=True)
    print(json.dumps({"kernels": [{
        "name": "kmeans_assign", "route": "cuda",
        "source": "src/repro_torch/csrc/kmeans_assign.cu",
        "replaces": "src/repro/kernels/kmeans_assign/kernel.py:20",
        "launches": launches["kmeans_assign"], "max_abs_err": main_err,
        "ms": step["ms"], "kernel_ms": step["ms"],
        "call_ms": step["call_ms"],
        "plain_ms": step["plain_ms"], "bound_ms": step["bound_ms"],
        "bound_by": step["bound_by"], "library_ms": step["library_ms"],
        "launch_floor_ms": launch_floor_ms, "shapes": shapes}]}),
        flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. device  -- require CUDA, turn TF32 off, report the card;
2. build   -- compile every kernel of the port from ``src/repro_torch/csrc``
              with nvcc for sm_90a, one nvcc per source, all at once
              (ptxas report included): ``kmeans_assign``, ``ssd_scan`` and
              ``flash_attention`` (the bf16 and f32 instances' shared
              memory of the last two, and the tensor-core instructions in
              each instance's SASS by ``cuobjdump``: every bf16 instance
              must have some);
3. kernel  -- hold each kernel against its plain PyTorch version on the
              card, at the reference tests' shapes and the main paths';
4. slice   -- the paper's host EL loop at full width: kmeans-traffic
              (20,000 samples, 4 edges, batch 128, budget 5000 per edge)
              through ``ELSession.run_sync`` and ``run_async`` on the card;
              the same runs on the CPU with the plain E-step must make the
              same decisions; then svm-wafer sync at full width;
4b. compiled -- the same two workloads through the compiled sync round
              (``ELSession.run_sync_ingraph``: chunks of masked rounds,
              each a CUDA graph replay, the bandit on the card, every
              K-means local step one launch of ``kmeans_assign``'s batched
              entry): on draws replayed from a seeded CPU generator the
              card's decisions must equal the port's own CPU run's; then
              on the card's own generator, run seconds, rounds, chunks
              (host syncs), graphs, replays and kernel launches beside the
              host loop's seconds;
4c. async  -- the same two workloads through the compiled async event
              engine (``ELSession.run_async_ingraph``: chunks of masked
              event steps, each a CUDA graph replay, one bandit per edge
              on the card, every K-means local step one launch of
              ``kmeans_assign``'s batched entry), single events and
              K-event waves of 4: on replayed draws the card's events
              (order, intervals, charges, times) must equal the port's
              CPU run's, and the waves' the single events'; then on the
              card's own generator, run seconds, events, chunks, graphs,
              replays and kernel launches beside the host ``run_async``'s
              seconds;
5. serve   -- mamba2-370m at full width (48 layers, d_model 1024, bf16,
              random weights from a seeded generator) through the port's
              ``ServingEngine``: 4 slots, 8 greedy requests of 16 tokens
              arriving over time (one admitted mid-flight), every Mamba
              layer's prefill through the ``ssd_scan`` kernel; then the
              same prompts' prefill with the plain SSD, compared;
6. train   -- qwen3-1.7b at full width (28 layers, d_model 2048, 16 query
              and 8 KV heads of 128, vocab 151,936, bf16, remat; random
              weights from a seeded generator) through the port's
              ``launch.train.train_standard``: 3 AdamW steps at B = 8,
              S = 512, every attention layer's forward (and its remat
              recompute) through the ``flash_attention`` kernel; then one
              step's loss and gradient norm with the kernel and with the
              plain naive attention, at f32 and bf16, compared;
7. ol4el   -- the paper's loop over the same LM at full width
              (``launch.train.train_ol4el``, sync, 2 edges, B = 4,
              S = 128, 2 rounds);
8. kernels -- per-kernel launches, error, times (CUDA events) and bound,
              beside the time of one empty launch (the batched
              ``kmeans_assign`` beside 4 single launches); ``ssd_scan`` and
              ``flash_attention`` also per instance (bf16 on the tensor
              cores, f32 on the CUDA cores, each bound at its own rate) at
              the serving and the training shape.

Each path (4, 4b, 4c, 5, 6, 7) is driven with every kernel's launch count set to 0
just before it and read just after.  Then the card's name and power limit
(nvidia-smi), and last ``{"ok": true, "device": {...}}``.  Any failed
check exits non-zero, as does a machine without CUDA or a directory
without the repo's sources.  The script imports nothing of JAX and
nothing of the JAX package.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12           # f32 outside the tensor cores
H100_BF16_FLOPS = 989e12         # bf16 on the tensor cores, dense


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
# path's local-step minibatch and evaluation-set shapes; then the lane-group
# kernel's branches: D = 59 (not a multiple of its 8 lanes: scalar loads)
# in bf16, D = 300 (32 lanes, past the 8 elements a lane keeps), N = 1001
# (not a multiple of the block's 16 points), and more lanes than a bf16
# row has 16-byte vectors (8 lanes for 5 at D = 40, 4 for 3 at D = 24)
KM_CASES = [(100, 8, 3, "float32"), (1000, 64, 3, "float32"),
            (513, 59, 8, "float32"), (256, 16, 32, "float32"),
            (300, 64, 3, "bfloat16"), (128, 64, 3, "float32"),
            (4000, 64, 3, "float32"), (200, 59, 3, "bfloat16"),
            (64, 300, 4, "float32"), (1001, 64, 3, "float32"),
            (300, 40, 3, "bfloat16"), (200, 24, 3, "bfloat16")]
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
    from repro_torch.kernels.kmeans_assign import kernel, ops, ref
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
             dtype=dt, group=kernel.lane_group(d), max_abs_err=err,
             assign_agree=agree)
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


# (e, n, d, k, dtype name) of the batched entry: the compiled round's local
# step (4 edges of (128, 64, 3)), N not a multiple of the block's points,
# wafer widths (scalar loads), K = 1, bf16
KM_BATCHED_CASES = [(4, 128, 64, 3, "float32"), (4, 1001, 64, 3, "float32"),
                    (3, 513, 59, 8, "float32"), (2, 100, 64, 1, "float32"),
                    (3, 300, 64, 3, "bfloat16")]
KM_BATCHED_MAIN = (4, 128, 64, 3)


def km_batched_inputs(e, n, d, k, dtype_name, seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    dtype = getattr(torch, dtype_name)
    x = torch.randn(e, n, d, generator=g).to("cuda", dtype)
    c = torch.randn(e, k, d, generator=g).to("cuda", dtype)
    return x, c


def kernel_batched_vs_plain() -> float:
    """The batched entry bit-equal to E single launches, and within the
    single entry's tolerance of the plain version; returns the largest
    |d2 - d2_plain| at the main path's shape."""
    import torch
    from repro_torch.kernels.kmeans_assign import ops, ref
    main_err = 0.0
    for i, (e, n, d, k, dt) in enumerate(KM_BATCHED_CASES):
        x, c = km_batched_inputs(e, n, d, k, dt, seed=50 + i)
        a, d2 = ops.assign_with_dist_batched(x, c)
        singles = [ops.assign_with_dist(x[j], c[j]) for j in range(e)]
        a_ref, d2_ref = ref.assign_ref(x, c)
        torch.cuda.synchronize()
        bit_equal = all(torch.equal(a[j], sa) and torch.equal(d2[j], sd)
                        for j, (sa, sd) in enumerate(singles))
        tol = (1e-2, 1e-2) if dt == "bfloat16" else (1e-4, 1e-3)
        err = float((d2 - d2_ref).abs().max())
        agree = float((a == a_ref).float().mean())
        emit("kernel_vs_plain", kernel="kmeans_assign_batched", e=e, n=n,
             d=d, k=k, dtype=dt, bit_equal_to_singles=bit_equal,
             max_abs_err=err, assign_agree=agree)
        check(bit_equal, f"kmeans_assign batched != {e} single launches at "
              f"{(e, n, d, k, dt)}")
        check(torch.allclose(d2, d2_ref, rtol=tol[0], atol=tol[1]),
              f"kmeans_assign batched d2 off at {(e, n, d, k, dt)}: {err}")
        check(dt == "bfloat16" or agree >= 0.999,
              f"kmeans_assign batched assignments agree {agree}")
        if (e, n, d, k) == KM_BATCHED_MAIN:
            main_err = err
    return main_err


# (b, s, h, p, n, chunk, dtype name): the reference's kernel-test cases,
# then the main path's prefill shapes (mamba2-370m: 4 slots, 32 heads of
# 64, d_state 128, chunk 128; the mid-flight prefills of 514-529 tokens
# pad to 640, a lone admitted prompt is B = 1), and ragged chunks (a
# 100-token prompt gives L = 100); then the bf16 (tensor-core) instance's
# branches: P tile P (the serving shape; B * H = 160) and P / 2 (a lone
# prompt), P = N = 128 (jamba-1.5's head dim and d_state) with P tiles of
# 64 and of 128 (a warp holding 4 state items), N = 16 with a ragged L
SSD_CASES = [(2, 128, 4, 32, 16, 32, "float32"),
             (1, 256, 2, 64, 128, 128, "float32"),
             (1, 64, 8, 64, 64, 32, "float32"),
             (2, 128, 2, 128, 128, 64, "float32"),
             (1, 128, 4, 32, 16, 32, "bfloat16"),
             (4, 512, 32, 64, 128, 128, "bfloat16"),
             (4, 512, 32, 64, 128, 128, "float32"),
             (4, 640, 32, 64, 128, 128, "bfloat16"),
             (4, 100, 32, 64, 128, 100, "bfloat16"),
             (2, 100, 4, 64, 128, 100, "float32"),
             (1, 128, 32, 64, 128, 128, "bfloat16"),
             (5, 256, 32, 64, 128, 128, "bfloat16"),
             (2, 256, 8, 128, 128, 128, "bfloat16"),
             (1, 128, 136, 128, 32, 64, "bfloat16"),
             (2, 128, 70, 128, 128, 64, "bfloat16"),
             (2, 100, 4, 32, 16, 100, "bfloat16")]
# shapes the bf16 instance refuses, with the error's words: N not a
# multiple of 16, and a plan beyond the card's shared memory
SSD_REFUSED = [((1, 128, 2, 32, 24, 64), "multiples of 16"),
               ((1, 128, 2, 64, 256, 128), "shared memory")]
SSD_MAIN = (4, 512, 32, 64, 128, 128, "bfloat16")


def ssd_inputs(b, s, h, p, n, dtype_name, seed):
    """The reference test's recipe, drawn on the card: x * softplus(dt)
    and B, C in ``dtype``, da = dt * A in f32 (A < 0)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    dtype = getattr(torch, dtype_name)

    def normal(*shape):
        return torch.randn(*shape, generator=g, device="cuda")
    x = normal(b, s, h, p)
    dt = torch.nn.functional.softplus(normal(b, s, h)).to(dtype).float()
    a = -torch.exp(0.5 * normal(h))
    xs = (x.to(dtype).float() * dt[..., None]).to(dtype)
    return xs, (dt * a).contiguous(), normal(b, s, n).to(dtype), \
        normal(b, s, n).to(dtype)


def ssd_compare(y, state, x, da, bm, cm, chunk) -> dict:
    """Kernel vs plain version within ``ref.allowed_error`` (the rule the
    card tests hold it to), with the count beyond the reference test's
    bare tolerance and both sides' distance from the exact (f64) value
    reported beside."""
    import torch
    from repro_torch.kernels.ssd_scan import ref
    y64, st64 = ref.ssd_reference(x.double(), da.double(), bm.double(),
                                  cm.double(), chunk)
    tol = ref.tolerance(x.dtype)
    out = {"tol": tol}
    for name, got, (want, allowed), exact in zip(
            ("y", "state"), (y, state),
            ref.allowed_error(x, da, bm, cm, chunk), (y64, st64)):
        got = got.double()
        err = (got - want).abs()
        out[name] = {
            "max_abs_err": float(err.max()),
            "beyond_plain_tol": int((err > tol + tol * want.abs()).sum()),
            "beyond_allowed": int((err > allowed).sum()),
            "kernel_vs_f64": float((got - exact).abs().max()),
            "plain_vs_f64": float((want - exact).abs().max()),
            "finite": bool(torch.isfinite(got).all())}
    return out


def ssd_vs_plain() -> float:
    """Returns the largest |y - y_plain| at the main path's shape."""
    import torch
    from repro_torch.kernels.ssd_scan import kernel, ops
    main_err = 0.0
    limit, sms = kernel.max_smem(0), kernel.sm_count(0)
    for i, case in enumerate(SSD_CASES):
        b, s, h, p, n, chunk, dt = case
        x, da, bm, cm = ssd_inputs(b, s, h, p, n, dt, seed=100 + i)
        y, state = ops.ssd(x, da, bm, cm, chunk)
        torch.cuda.synchronize()
        res = ssd_compare(y, state, x, da, bm, cm, chunk)
        emit("kernel_vs_plain", kernel="ssd_scan", b=b, s=s, h=h, p=p, n=n,
             chunk=chunk, dtype=dt, p_tile=kernel.p_tile(
                 b, h, p, n, chunk, x.dtype, limit, sms), **res)
        for part in ("y", "state"):
            check(res[part]["finite"] and res[part]["beyond_allowed"] == 0,
                  f"ssd_scan {part} off at {case}: {res[part]}")
        if case == SSD_MAIN:
            main_err = res["y"]["max_abs_err"]
    # strongly negative da: exp above the diagonal would overflow to inf
    for shape in ((1, 128, 4, 32, 16, "float32"),
                  (2, 256, 4, 64, 128, "bfloat16")):
        x, da, bm, cm = ssd_inputs(*shape, seed=7)
        y, state = ops.ssd(x, da * 200.0, bm, cm, 128)
        torch.cuda.synchronize()
        res = ssd_compare(y, state, x, da * 200.0, bm, cm, 128)
        emit("kernel_vs_plain", kernel="ssd_scan", case="da*200",
             dtype=shape[-1], **res)
        check(res["y"]["finite"] and res["state"]["finite"]
              and res["y"]["beyond_allowed"] == 0
              and res["state"]["beyond_allowed"] == 0,
              f"ssd_scan large-decay case {shape}: {res}")
    for (b, s, h, p, n, chunk), words in SSD_REFUSED:
        before = ops.launches
        try:
            ops.ssd(*ssd_inputs(b, s, h, p, n, "bfloat16", seed=8), chunk)
            refused = ""
        except ValueError as e:
            refused = str(e)
        emit("kernel_refuses", kernel="ssd_scan", b=b, s=s, h=h, p=p, n=n,
             chunk=chunk, dtype="bfloat16", error=refused)
        check(words in refused and ops.launches == before,
              f"ssd_scan bf16 did not refuse {(p, n, chunk)}: {refused!r}")
    return main_err


# (b, s, h, kv, d, window, dtype name): the reference's kernel-test cases
# (MQA, windows 128 and 64, D 64/128/256, bf16), ragged S, then the
# training shape (qwen3-1.7b: 16 query and 8 KV heads of 128, B = 8,
# S = 512) in f32 and the config's bf16; then every branch of the bf16
# (tensor-core) instance: D 64, 128 and 256, GQA groups 1, 2 and 8,
# S = 17 and 300 (not multiples of its 64-row tiles) and 512, windows of
# 100 and 64 that start mid-tile
FLASH_CASES = [(1, 128, 4, 4, 64, 0, "float32"),
               (2, 256, 4, 2, 64, 0, "float32"),
               (1, 256, 8, 1, 64, 0, "float32"),
               (1, 128, 4, 4, 128, 0, "float32"),
               (1, 128, 2, 2, 256, 0, "float32"),
               (2, 256, 4, 2, 64, 128, "float32"),
               (1, 256, 4, 4, 64, 64, "float32"),
               (1, 128, 4, 2, 64, 0, "bfloat16"),
               (2, 300, 4, 2, 128, 0, "float32"),
               (2, 300, 4, 2, 64, 100, "bfloat16"),
               (8, 512, 16, 8, 128, 0, "float32"),
               (8, 512, 16, 8, 128, 0, "bfloat16"),
               (1, 17, 4, 4, 64, 0, "bfloat16"),
               (2, 17, 16, 2, 128, 0, "bfloat16"),
               (1, 17, 2, 1, 256, 0, "bfloat16"),
               (2, 300, 16, 2, 128, 0, "bfloat16"),
               (1, 300, 4, 2, 256, 0, "bfloat16"),
               (1, 512, 8, 1, 256, 0, "bfloat16"),
               (2, 512, 4, 4, 64, 0, "bfloat16"),
               (1, 512, 8, 4, 128, 100, "bfloat16"),
               (2, 300, 4, 4, 128, 64, "bfloat16"),
               (1, 512, 4, 2, 256, 64, "bfloat16")]
# the same fields, causal=False: the bf16 instance without the causal
# bound, ragged, and with a window that starts mid-tile
FLASH_NON_CAUSAL = [(1, 300, 4, 2, 128, 0, "bfloat16"),
                    (2, 17, 8, 1, 64, 0, "bfloat16"),
                    (1, 300, 4, 1, 64, 100, "bfloat16")]
FLASH_MAIN = (8, 512, 16, 8, 128, 0, "bfloat16")


def flash_inputs(b, s, h, kv, d, dtype_name, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    dtype = getattr(torch, dtype_name)
    return [torch.randn(*shape, generator=g, device="cuda").to(dtype)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]


def flash_vs_plain() -> float:
    """Every case within ``ref.allowed_error`` (the rule the card tests
    hold the kernel to: the reference test's bare tolerance); returns the
    largest |o - o_plain| at the main path's shape."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    main_err = 0.0
    cases = [(c, True) for c in FLASH_CASES] + \
        [(c, False) for c in FLASH_NON_CAUSAL]
    for i, (case, causal) in enumerate(cases):
        b, s, h, kv, d, window, dt = case
        q, k, v = flash_inputs(b, s, h, kv, d, dt, seed=200 + i)
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want, allowed = ref.allowed_error(q, k, v, causal=causal,
                                          window=window)
        exact = ref.attention_ref(q.double(), k.double(), v.double(),
                                  causal=causal, window=window).double()
        err = (out.double() - want).abs()
        res = {"max_abs_err": float(err.max()),
               "beyond_allowed": int((err > allowed).sum()),
               "kernel_vs_f64": float((out.double() - exact).abs().max()),
               "plain_vs_f64": float((want - exact).abs().max()),
               "finite": bool(torch.isfinite(out).all())}
        emit("kernel_vs_plain", kernel="flash_attention", b=b, s=s, h=h,
             kv=kv, d=d, window=window, causal=causal, dtype=dt,
             tol=ref.tolerance(q.dtype), **res)
        check(res["finite"] and res["beyond_allowed"] == 0,
              f"flash_attention off at {case}, causal={causal}: {res}")
        if causal and case == FLASH_MAIN:
            main_err = res["max_abs_err"]
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
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.kmeans_assign import ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch.classic import classic_fixture

    gpu = classic_fixture("kmeans-traffic", samples=20000, n_edges=4,
                          device="cuda")
    check(gpu["model"].impl == "cuda", "kmeans on CUDA must use the kernel")
    init = params_to_numpy(gpu["init_params"])

    # the main path: every kernel count is read around exactly this run
    ops.launches = 0
    ssd_ops.launches = 0
    fa_ops.launches = 0
    gpu_reports, per_mode = {}, {}
    for mode in ("sync", "async"):
        before = ops.launches
        rep, secs = run_session(gpu, mode, params_from_numpy(init, "cuda"))
        torch.cuda.synchronize()
        gpu_reports[mode] = (rep, secs)
        per_mode[mode] = ops.launches - before
        check(per_mode[mode] > 0, f"kmeans {mode}: kernel never launched")
    launches = ops.launches
    check(ssd_ops.launches == 0 and fa_ops.launches == 0,
          "the EL loop launched ssd_scan or flash_attention")

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
    host_s = {"kmeans-traffic": gpu_reports["sync"][1], "svm-wafer": secs}
    return {"kmeans_assign": launches}, host_s


# -- phase 4b: the compiled sync round ---------------------------------------------

COMPILED_ROUNDS = 512             # run_sync_ingraph's default horizon


def compiled_session(fx, init):
    from repro_torch.el import ELSession
    cfg = dataclasses.replace(fx["exp"].ol4el, mode="sync", n_edges=4,
                              utility=fx["utility"])
    return (ELSession(cfg, metric_name=fx["metric"], lr=fx["lr"])
            .with_executor(fx["executor"], init_params=init,
                           n_samples=fx["n_samples"]))


def replay_draws(cfg, batch, seed):
    """The compiled round's draws for every round of the horizon from a
    seeded CPU generator (numpy), handed to both devices alike."""
    import numpy as np
    from repro_torch.el.rng import ReplayDraws
    rng = np.random.default_rng(seed)
    k, e = cfg.max_interval, cfg.n_edges
    return ReplayDraws(rng.gumbel(size=(COMPILED_ROUNDS, k)),
                       rng.uniform(size=(COMPILED_ROUNDS, e, k, batch)),
                       rng.standard_normal((COMPILED_ROUNDS, e)))


def flip_bound(arch, y) -> float:
    return f1_flip_bound(y) if arch == "kmeans-traffic" else 1.0 / len(y)


def classic_fixtures() -> dict:
    from repro_torch.launch.classic import classic_fixture
    return {arch: {dev: classic_fixture(arch, samples=20000, n_edges=4,
                                        device=dev)
                   for dev in ("cuda", "cpu")}
            for arch in ("kmeans-traffic", "svm-wafer")}


def compiled_phase(host_s: dict, fixtures) -> dict:
    import math
    import torch
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.kernels.kmeans_assign import ops

    # (a) replayed draws: the card's decisions are the CPU run's
    for arch, fx in fixtures.items():
        init = params_to_numpy(fx["cuda"]["init_params"])
        reps = {}
        for dev in ("cuda", "cpu"):
            sess = compiled_session(fx[dev], params_from_numpy(init, dev))
            draws = replay_draws(sess.cfg, fx[dev]["executor"].batch, seed=3)
            reps[dev] = sess.run_sync_ingraph(max_rounds=COMPILED_ROUNDS,
                                              draws=draws)
        gpu, cpu = reps["cuda"], reps["cpu"]
        bound = flip_bound(arch, fx["cpu"]["executor"].eval_set["y"].numpy())
        same = [r.interval for r in gpu.records] == \
            [r.interval for r in cpu.records]
        emit("compiled_vs_cpu", arch=arch, draws="replayed (numpy seed 3)",
             rounds=gpu.n_aggregations, cpu_rounds=cpu.n_aggregations,
             same_intervals=same, arm_pulls=gpu.arm_pulls,
             cpu_arm_pulls=cpu.arm_pulls, reason=gpu.terminated_reason,
             final_metric=gpu.final_metric, cpu_final_metric=cpu.final_metric,
             flip_bound=bound, consumed=gpu.total_consumed,
             cpu_consumed=cpu.total_consumed,
             device_loop=gpu.telemetry["device_loop"])
        check(same, f"compiled {arch}: card and CPU intervals differ")
        check(gpu.arm_pulls == cpu.arm_pulls and gpu.terminated_reason ==
              cpu.terminated_reason, f"compiled {arch}: arm pulls or end")
        check(abs(gpu.final_metric - cpu.final_metric) <= bound,
              f"compiled {arch}: final metric {gpu.final_metric} vs CPU "
              f"{cpu.final_metric}")

    # (b) the card's own generator: the main path, counts read around it
    result = {}
    reset_counts()
    torch.cuda.synchronize()
    for arch, fx in fixtures.items():
        sess = compiled_session(fx["cuda"], fx["cuda"]["init_params"])
        runs = []
        for _ in range(2):             # the first run captures the graph
            before = ops.batched_launches
            t0 = time.perf_counter()
            rep = sess.run_sync_ingraph(max_rounds=COMPILED_ROUNDS)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            loop = rep.telemetry["device_loop"]
            runs.append({"run_s": secs, "rounds": rep.n_aggregations,
                         "kernel_launches": ops.batched_launches - before,
                         "reason": rep.terminated_reason,
                         "final_metric": rep.final_metric,
                         "arm_pulls": rep.arm_pulls, **loop})
            check(rep.terminated_reason == "budget_exhausted"
                  and rep.n_aggregations > 0
                  and math.isfinite(rep.final_metric)
                  and all(bool(torch.isfinite(v).all())
                          for v in rep.final_params.values()),
                  f"compiled {arch}: {rep.summary()}")
        emit("compiled", arch=arch, device="cuda", draws="torch.Generator "
             "on the card, seed cfg.seed + 17", runs=runs,
             host_loop_run_s=host_s[arch])
        check(runs[0]["graphs_captured"] == 1 and
              runs[1]["graphs_captured"] == 0 and
              all(r["replays"] == r["chunks"] > 0 for r in runs),
              f"compiled {arch}: graphs / replays {runs}")
        result[arch] = runs
    launches = counts()
    km = result["kmeans-traffic"]
    check(launches["kmeans_assign_batched"] > 0 and
          launches["kmeans_assign_batched"] == sum(
              r["kernel_launches"] for r in km),
          f"compiled kmeans: batched kmeans_assign launches {launches}")
    # the single entry runs once per kmeans run: the report's final F1
    # (``ex.evaluate``'s E-step over the evaluation set)
    check(launches["kmeans_assign"] == len(km) and
          launches["ssd_scan"] == 0 and launches["flash_attention"] == 0,
          f"compiled: unexpected kernel launches {launches}")
    return {"kmeans_assign_batched": launches["kmeans_assign_batched"],
            "runs": result}


# -- phase 4c: the compiled async event engine ---------------------------------------

ASYNC_EVENTS = 512                # the full-width runs' padded horizon (336)
ASYNC_WAVE = 4                    # the pinned wave width, all four edges


def async_session(fx, init, batch_k):
    from repro_torch.el import ELSession
    cfg = dataclasses.replace(fx["exp"].ol4el, mode="async", n_edges=4,
                              utility=fx["utility"], async_batch_k=batch_k)
    return (ELSession(cfg, metric_name=fx["metric"], lr=fx["lr"])
            .with_executor(fx["executor"], init_params=init,
                           n_samples=fx["n_samples"]))


def async_replay_draws(cfg, batch, seed):
    """Every edge's draws for every event of the horizon, and the initial
    round's, from a seeded CPU generator (numpy), handed to both devices
    alike."""
    import numpy as np
    from repro_torch.el.rng import ReplayDraws
    rng = np.random.default_rng(seed)
    k, e = cfg.max_interval, cfg.n_edges
    return ReplayDraws(rng.gumbel(size=(ASYNC_EVENTS, e, k)),
                       rng.uniform(size=(ASYNC_EVENTS, e, k, batch)),
                       rng.standard_normal((ASYNC_EVENTS, e)),
                       init_gumbel=rng.gumbel(size=(e, k)),
                       init_normal=rng.standard_normal(e))


def event_decisions(rep):
    """Event order, intervals, charged totals and event times: at fixed
    cost the same bits on every device."""
    return [(r.edge, r.interval, r.total_consumed, r.wall_time)
            for r in rep.records]


def max_param_diff(a, b) -> float:
    return max(float((a[k].float().cpu() - b[k].float().cpu()).abs().max())
               for k in a)


def async_phase(fixtures) -> dict:
    import math
    import torch
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.kernels.kmeans_assign import ops

    # (a) replayed draws: the card's decisions are the CPU run's, and a
    # K-event wave's the single events'
    for arch, fx in fixtures.items():
        init = params_to_numpy(fx["cuda"]["init_params"])
        reps = {}
        for dev, bk in (("cuda", 1), ("cpu", 1), ("cuda", ASYNC_WAVE)):
            sess = async_session(fx[dev], params_from_numpy(init, dev), bk)
            draws = async_replay_draws(sess.cfg, fx[dev]["executor"].batch,
                                       seed=5)
            reps[dev, bk] = sess.run_async_ingraph(draws=draws)
        gpu, cpu, wave = reps["cuda", 1], reps["cpu", 1], \
            reps["cuda", ASYNC_WAVE]
        bound = flip_bound(arch, fx["cpu"]["executor"].eval_set["y"].numpy())
        same = event_decisions(gpu) == event_decisions(cpu)
        same_wave = event_decisions(wave) == event_decisions(gpu)
        emit("async_vs_cpu", arch=arch, draws="replayed (numpy seed 5)",
             events=gpu.n_aggregations, cpu_events=cpu.n_aggregations,
             wave_events=wave.n_aggregations, same_decisions=same,
             wave_same_decisions=same_wave, arm_pulls=gpu.arm_pulls,
             cpu_arm_pulls=cpu.arm_pulls, wave_arm_pulls=wave.arm_pulls,
             reason=gpu.terminated_reason, consumed=gpu.total_consumed,
             cpu_consumed=cpu.total_consumed, wall=gpu.wall_time,
             cpu_wall=cpu.wall_time, final_metric=gpu.final_metric,
             cpu_final_metric=cpu.final_metric,
             wave_final_metric=wave.final_metric, flip_bound=bound,
             wave_max_param_diff=max_param_diff(wave.final_params,
                                                gpu.final_params),
             device_loop=gpu.telemetry["device_loop"],
             wave_device_loop=wave.telemetry["device_loop"])
        check(same, f"async {arch}: card and CPU events differ")
        check(same_wave, f"async {arch}: batch_k={ASYNC_WAVE} and "
              "batch_k=1 events differ on the card")
        for other in (cpu, wave):
            check(other.arm_pulls == gpu.arm_pulls and
                  other.terminated_reason == gpu.terminated_reason ==
                  "budget_exhausted", f"async {arch}: arm pulls or end")
            check(abs(other.final_metric - gpu.final_metric) <= bound,
                  f"async {arch}: final metric {other.final_metric} vs "
                  f"{gpu.final_metric}")

    # the yardstick: the host event loop on numpy streams, on the card
    host_s = {}
    for arch, fx in fixtures.items():
        sess = async_session(fx["cuda"], fx["cuda"]["init_params"], 1)
        t0 = time.perf_counter()
        rep = sess.run_async()
        torch.cuda.synchronize()
        host_s[arch] = {"run_s": time.perf_counter() - t0,
                        "events": rep.n_aggregations}

    # (b) the card's own generator: the main path, counts read around it
    result = {}
    reset_counts()
    torch.cuda.synchronize()
    for arch, fx in fixtures.items():
        for bk in (1, ASYNC_WAVE):
            sess = async_session(fx["cuda"], fx["cuda"]["init_params"], bk)
            runs = []
            for _ in range(2):         # the first run captures the graph
                before = ops.batched_launches
                t0 = time.perf_counter()
                rep = sess.run_async_ingraph()
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                loop = rep.telemetry["device_loop"]
                runs.append({"run_s": secs, "events": rep.n_aggregations,
                             "kernel_launches": ops.batched_launches - before,
                             "reason": rep.terminated_reason,
                             "final_metric": rep.final_metric,
                             "arm_pulls": rep.arm_pulls, **loop})
                check(rep.terminated_reason == "budget_exhausted"
                      and rep.n_aggregations > 0
                      and all(bool(torch.isfinite(v).all())
                              for v in rep.final_params.values())
                      and math.isfinite(rep.final_metric),
                      f"async {arch} batch_k={bk}: {rep.summary()}")
            emit("async", arch=arch, device="cuda", batch_k=bk,
                 draws="torch.Generator on the card, seed cfg.seed + 17",
                 runs=runs, host_run_async=host_s[arch])
            check(runs[0]["graphs_captured"] == 1 and
                  runs[1]["graphs_captured"] == 0 and
                  all(r["replays"] == r["chunks"] > 0 for r in runs),
                  f"async {arch} batch_k={bk}: graphs / replays {runs}")
            check(runs[0]["events"] == runs[1]["events"] and
                  runs[0]["arm_pulls"] == runs[1]["arm_pulls"],
                  f"async {arch} batch_k={bk}: the two runs differ")
            if arch == "kmeans-traffic":
                for r in runs:
                    # every local step of every step, masked or not; the
                    # capture's warm-up chunk runs eagerly
                    per_graph = r["rounds_per_chunk"] * 10
                    check(r["kernel_launches_per_graph"] == per_graph and
                          r["kernel_launches"] == per_graph * (
                              r["replays"] + r["graphs_captured"]),
                          f"async kmeans batch_k={bk}: launches {r}")
            result[arch, bk] = runs
    launches = counts()
    km = result["kmeans-traffic", 1] + result["kmeans-traffic", ASYNC_WAVE]
    check(launches["kmeans_assign_batched"] == sum(
              r["kernel_launches"] for r in km) > 0,
          f"async kmeans: batched kmeans_assign launches {launches}")
    # the single entry runs once per kmeans run: the report's final F1
    check(launches["kmeans_assign"] == len(km) and
          launches["ssd_scan"] == 0 and launches["flash_attention"] == 0,
          f"async: unexpected kernel launches {launches}")
    return {"kmeans_assign": launches["kmeans_assign"],
            "kmeans_assign_batched": launches["kmeans_assign_batched"]}


# -- phase 5: mamba2-370m serving ---------------------------------------------

# (arrival step, prompt length): three prompts open the first wave and
# leave a slot free; a short one arrives while they decode and is admitted
# mid-flight; four more arrive and take the slots the first wave frees
SERVE_TRAFFIC = [(0, 512), (0, 437), (0, 300), (3, 128),
                 (8, 200), (8, 480), (8, 256), (8, 333)]
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_NEW_TOKENS = 4, 1024, 16
# kernel vs plain SSD through the whole 48-layer model, as the largest
# difference over the largest magnitude of each compared tensor.  At f32
# the two differ by f32 summation order only: 1e-3.  At bf16 the kernel's
# y and the plain version's round to bf16 on either side of a boundary
# here and there (one ulp, 2^-8 relative), and 48 residual layers of
# random weights amplify that, so the kernel path is held to the bf16
# model's own rounding error measured in the same run: its distance from
# the plain path may not exceed the plain bf16 path's from the plain f32
# path.  (A fixed 5e-2 was tried first and missed: 0.054 logits, 0.059
# SSM state, 0.041 conv.)
SERVE_F32_TOL = 1e-3


class Timed:
    """Proxy of a model that times ``prefill`` / ``decode_step`` with the
    card synchronised around each call (host clock)."""

    def __init__(self, model):
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.times = {"prefill": [], "decode": []}
        self.prefill_lens = []

    def _timed(self, key, fn, *args):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        self.times[key].append(time.perf_counter() - t0)
        return out

    def init_cache(self, *args):
        return self.model.init_cache(*args)

    def prefill(self, params, tokens, cache):
        self.prefill_lens.append(int(tokens.shape[1]))
        return self._timed("prefill", self.model.prefill, params, tokens,
                           cache)

    def decode_step(self, params, tokens, cache):
        return self._timed("decode", self.model.decode_step, params, tokens,
                           cache)


def serve_phase() -> dict:
    import torch
    from repro_torch.config import get_config
    from repro_torch.interop import tree_map
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.kmeans_assign import ops as km_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch.serve import build
    from repro_torch.serving import Request, ServingEngine

    cfg = get_config("mamba2-370m").model
    t0 = time.perf_counter()
    model, params, tokens = build(cfg, len(SERVE_TRAFFIC), 512, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(model.use_ssd_kernel, "mamba2 on CUDA must use the ssd_scan kernel")
    sizes = []
    tree_map(lambda t: sizes.append(t.numel()), params)
    n_params = sum(sizes)
    # num_params() is the reference's analytic count; the tree also holds
    # each layer's dt_bias [H] and the conv bias's 2N entries beyond it
    mc = cfg.mamba
    check(n_params == cfg.num_params() + cfg.n_layers * (
        mc.n_heads(cfg.d_model) + 2 * mc.d_state),
        f"mamba2-370m holds {n_params} parameters, not its full width")
    tokens = tokens.cpu().numpy()
    prompts = [tokens[i, :n] for i, (_, n) in enumerate(SERVE_TRAFFIC)]

    timed = Timed(model)
    eng = ServingEngine(timed, params, n_slots=SERVE_SLOTS,
                        max_len=SERVE_MAX_LEN, seed=0)
    pending = list(enumerate(SERVE_TRAFFIC))
    done, mid_flight, step = [], [], 0
    submitted, token_times = {}, {uid: [] for uid in range(len(prompts))}
    # the main path: every kernel count is read around exactly this run
    ssd_ops.launches = 0
    km_ops.launches = 0
    fa_ops.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        while pending or eng.has_work():
            while pending and pending[0][1][0] <= step:
                uid, _ = pending.pop(0)
                eng.submit(Request(uid=uid, prompt=prompts[uid],
                                   max_new_tokens=SERVE_NEW_TOKENS))
                submitted[uid] = time.perf_counter()
            before = {r.uid for r in eng.slot_req if r is not None}
            was_active = eng.active
            finished = eng.step()      # ends in a host read of the tokens
            now = time.perf_counter()
            done += finished
            for r in eng.slot_req + finished:
                if r is not None:
                    token_times[r.uid] += [now] * (
                        len(r.output) - len(token_times[r.uid]))
            if was_active:       # requests that joined a running batch
                mid_flight += [r.uid for r in eng.slot_req + finished
                               if r is not None and r.uid not in before]
            step += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, km_launches = ssd_ops.launches, km_ops.launches
    fa_launches = fa_ops.launches
    peak = torch.cuda.max_memory_allocated()

    n_prefill = len(timed.times["prefill"])
    outputs = {r.uid: r.output for r in done}
    new_tokens = sum(len(o) for o in outputs.values())
    ssm = eng.cache["groups"]["sub0"]["ssm"]
    decode_ms = [t * 1e3 for t in timed.times["decode"]]
    ttft_ms = sorted((token_times[u][0] - submitted[u]) * 1e3
                     for u in submitted)
    gaps_ms = sorted((b - a) * 1e3 for ts in token_times.values()
                     for a, b in zip(ts, ts[1:]))
    result = {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "dtype": cfg.dtype, "params": n_params, "init_s": init_s,
        "slots": SERVE_SLOTS, "requests": len(SERVE_TRAFFIC),
        "completed": len(done), "steps": step,
        "prefill_calls": n_prefill, "prefill_lens": timed.prefill_lens,
        "prefill_ms": [t * 1e3 for t in timed.times["prefill"]],
        "decode_steps": len(decode_ms),
        "decode_ms_mean": sum(decode_ms) / max(len(decode_ms), 1),
        "decode_ms_median": sorted(decode_ms)[len(decode_ms) // 2],
        "ttft_ms_median": ttft_ms[len(ttft_ms) // 2],
        "ttft_ms_max": ttft_ms[-1],
        "token_gap_ms_median": gaps_ms[len(gaps_ms) // 2],
        "token_gap_ms_max": gaps_ms[-1],
        "new_tokens": new_tokens, "wall_s": wall,
        "tokens_per_s": new_tokens / wall,
        "max_memory_allocated": peak, "mid_flight_admitted": mid_flight,
        "ssd_scan_launches": launches, "kmeans_assign_launches": km_launches,
        "flash_attention_launches": fa_launches}
    emit("serve", **result)
    check(len(done) == len(SERVE_TRAFFIC) and all(
        len(o) == SERVE_NEW_TOKENS for o in outputs.values()),
        f"serve: not every request completed {SERVE_NEW_TOKENS} tokens")
    check(all(0 <= t < cfg.vocab_size for o in outputs.values() for t in o),
          "serve: token out of the vocabulary")
    check(launches == cfg.n_layers * n_prefill and launches > 0,
          f"serve: ssd_scan launched {launches} times for {n_prefill} "
          f"prefills of {cfg.n_layers} layers")
    check(km_launches == 0 and fa_launches == 0,
          "serve: kmeans_assign or flash_attention launched")
    check(len(mid_flight) >= 1, "serve: no request was admitted mid-flight")
    check(bool(torch.isfinite(ssm).all()), "serve: non-finite SSM cache")

    rel_err, agree, flips_outside = serve_vs_plain(cfg, params, prompts)
    emit("serve_vs_plain", rel_err=rel_err, f32_tol=SERVE_F32_TOL,
         first_token_agree=agree, first_tokens=len(prompts),
         flips_beyond_margin=flips_outside)
    for t in ("logits", "ssm", "conv"):
        check(rel_err[f"kernel_vs_plain_f32.{t}"] <= SERVE_F32_TOL,
              f"serve f32: kernel vs plain SSD off in {t}: {rel_err}")
        check(rel_err[f"kernel_vs_plain_bf16.{t}"]
              <= rel_err[f"bf16_vs_f32_plain.{t}"],
              f"serve bf16: kernel vs plain SSD in {t} beyond the bf16 "
              f"model's own rounding: {rel_err}")
    check(flips_outside == 0,
          "serve: a greedy first token flipped beyond the logits' error "
          "margin")
    return {"ssd_scan": launches}


def serve_vs_plain(cfg, params, prompts):
    """The prompts' prefill, kernel vs plain SSD, in waves of
    ``SERVE_SLOTS``, at the config's bf16 and at f32 (same weights).

    Returns the largest relative error of each pair and tensor
    (``{"kernel_vs_plain_bf16.logits": ..., ...}``), the first tokens the
    kernel and plain paths agree on per dtype, and the first-token flips
    beyond the logits' error margin."""
    import torch
    from repro_torch.models import build_model
    models = {(dtype, kernel): build_model(
                  dataclasses.replace(cfg, dtype=dtype),
                  use_ssd_kernel=kernel, device="cuda")
              for dtype in ("bfloat16", "float32") for kernel in (True, False)}
    worst = {}                      # (pair name, tensor) -> relative error
    agree, flips_outside = {"bfloat16": 0, "float32": 0}, 0

    def rel(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())

    for w in range(0, len(prompts), SERVE_SLOTS):
        wave = prompts[w: w + SERVE_SLOTS]
        s = max(len(p) for p in wave)
        batch = torch.tensor([[0] * (s - len(p)) + list(p) for p in wave],
                             dtype=torch.int32, device="cuda")
        out = {}
        for key, m in models.items():
            with torch.inference_mode():
                logits, cache = m.prefill(params, batch,
                                          m.init_cache(len(wave), s))
            g = cache["groups"]["sub0"]
            out[key] = {"logits": logits[:, -1].float(), "ssm": g["ssm"],
                        "conv": g["conv"].float()}
            del logits
            for name, t in out[key].items():
                check(bool(torch.isfinite(t).all()),
                      f"serve compare {key}: non-finite {name}")
        pairs = {"kernel_vs_plain_f32": (("float32", True),
                                         ("float32", False)),
                 "kernel_vs_plain_bf16": (("bfloat16", True),
                                          ("bfloat16", False)),
                 "bf16_vs_f32_plain": (("bfloat16", False),
                                       ("float32", False))}
        for pname, (ka, kb) in pairs.items():
            for t in ("logits", "ssm", "conv"):
                worst[pname, t] = max(worst.get((pname, t), 0.0),
                                      rel(out[ka][t], out[kb][t]))
        for dtype in agree:
            lk = out[dtype, True]["logits"]
            lp = out[dtype, False]["logits"]
            same = lk.argmax(-1) == lp.argmax(-1)
            top2 = lp.topk(2, dim=-1).values
            margin = top2[:, 0] - top2[:, 1]
            agree[dtype] += int(same.sum())
            flips_outside += int((~same & (margin > 2 * float(
                (lk - lp).abs().max()))).sum())
    rel_err = {f"{p}.{t}": v for (p, t), v in worst.items()}
    return rel_err, agree, flips_outside


# -- phase 6: qwen3-1.7b training ------------------------------------------------

TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 3, 8, 512
# kernel vs naive attention through the whole 28-layer model from the same
# weights and batch: the logits of a forward pass (largest difference over
# largest magnitude), and one step's loss and gradient norm (relative).
# At f32 the two differ by f32 summation order only: 1e-3.  At bf16 the
# kernel rounds the unnormalised probabilities to bf16 where the plain
# version rounds the normalised ones, so the kernel path is held to the
# bf16 model's own rounding, measured in the same run: its logits and
# gradient norm may lie no further from the naive path's than the naive
# bf16 path's lie from the naive f32 path's.  The loss is a mean of
# per-token NLLs, each of which moves by at most twice the largest logit
# change (the log-softmax's gradient has L1 norm <= 2), so the bf16 loss
# gap is held to twice the logits' largest absolute difference.  (The
# first run held the bf16 loss to the naive bf16-vs-f32 loss gap and
# missed, 3.72e-5 against 3.57e-5: at random init the loss barely moves
# with bf16 rounding, which makes that gap no measure of it.)
TRAIN_F32_TOL = 1e-3


def train_args(**kw):
    """The launcher's arguments (``launch.train.parse_args``) for a run on
    the card."""
    from repro_torch.launch.train import parse_args
    args = parse_args(["--arch", "qwen3-1.7b", "--device", "cuda",
                       "--log-every", "1"])
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def reset_counts() -> None:
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.kmeans_assign import ops as km_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    fa_ops.launches = km_ops.launches = ssd_ops.launches = 0
    km_ops.batched_launches = 0


def counts() -> dict:
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.kmeans_assign import ops as km_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return {"flash_attention": fa_ops.launches,
            "kmeans_assign": km_ops.launches,
            "kmeans_assign_batched": km_ops.batched_launches,
            "ssd_scan": ssd_ops.launches}


def train_phase() -> dict:
    import math
    import torch
    from repro_torch.config import get_config
    from repro_torch.interop import tree_leaves
    from repro_torch.launch.train import train_standard

    exp = get_config("qwen3-1.7b")
    cfg = exp.model
    check(exp.train.global_batch == TRAIN_BATCH and exp.train.seq_len ==
          TRAIN_SEQ and exp.train.optimizer == "adamw" and cfg.remat,
          "qwen3-1.7b: the experiment's batch, sequence, optimizer or "
          "remat changed")
    args = train_args(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: every kernel count is read around exactly this run
    reset_counts()
    t0 = time.perf_counter()
    out = train_standard(exp, args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    leaves = tree_leaves(out["state"].params)
    n_params = sum(t.numel() for t in leaves)
    finite = all(bool(torch.isfinite(t).all()) for t in leaves)
    losses = [m["loss"] for m in out["metrics"]]
    step_ms = [t * 1e3 for t in out["step_s"]]
    median_ms = sorted(step_ms)[len(step_ms) // 2]
    # with remat each layer's forward runs again in the backward
    per_step = 2 * cfg.n_layers
    result = {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
        "head_dim": cfg.resolved_head_dim, "vocab": cfg.vocab_size,
        "dtype": cfg.dtype, "remat": cfg.remat, "params": n_params,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
        "optimizer": exp.train.optimizer, "losses": losses,
        "grad_norms": [m["grad_norm"] for m in out["metrics"]],
        "lrs": [m["lr"] for m in out["metrics"]],
        "step_ms": step_ms, "step_ms_median": median_ms,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (median_ms / 1e3),
        "wall_s": wall, "max_memory_allocated": peak,
        "launches": launches, "flash_launches_per_step": per_step}
    emit("train", **result)
    del out, leaves
    torch.cuda.empty_cache()
    # num_params() is the reference's analytic count; the tree also holds
    # each layer's q/k norm scales (2 * head_dim)
    check(n_params == cfg.num_params() + cfg.n_layers * 2
          * cfg.resolved_head_dim,
          f"qwen3-1.7b holds {n_params} parameters, not its full width")
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(x)
                                             for x in losses) and finite,
          f"train: non-finite loss or parameters: {losses}")
    check(launches["flash_attention"] == per_step * TRAIN_STEPS,
          f"train: flash_attention launched {launches['flash_attention']} "
          f"times, not {per_step} x {TRAIN_STEPS}")
    check(launches["kmeans_assign"] == 0 and launches["ssd_scan"] == 0,
          "train: kmeans_assign or ssd_scan launched")
    return {"flash_attention": launches["flash_attention"]}


def train_vs_plain() -> dict:
    """The kernel and the naive attention through the whole model, at f32
    and at the config's bf16, from the same weights and batch: a forward
    pass's logits, and one step's loss and gradient norm."""
    import torch
    from repro_torch.config import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import LM
    from repro_torch.train import clip_by_global_norm
    from repro_torch.train.state import loss_and_grads

    cfg = get_config("qwen3-1.7b").model
    params = LM(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    batch = SyntheticLMData.for_model(cfg, TRAIN_BATCH, TRAIN_SEQ).batch(
        0, 0, device="cuda")
    out, logits = {}, {}
    for dtype in ("float32", "bfloat16"):
        for impl in ("kernel", "naive"):
            model = LM(dataclasses.replace(cfg, dtype=dtype), attn_impl=impl,
                       device="cuda")
            reset_counts()
            with torch.no_grad():
                logits[dtype, impl] = model.forward(
                    params, batch["tokens"])[0].float()
            metrics, grads = loss_and_grads(model, params, batch)
            _, gnorm = clip_by_global_norm(grads, 0.0)
            out[dtype, impl] = {"loss": float(metrics["loss"]),
                                "grad_norm": float(gnorm),
                                "launches": counts()["flash_attention"]}
            del grads
            torch.cuda.empty_cache()

    def gap(a, b):
        la, lb = logits[a], logits[b]
        res = {k: abs(out[a][k] - out[b][k]) / abs(out[b][k])
               for k in ("loss", "grad_norm")}
        res["logits"] = float((la - lb).abs().max()) / float(lb.abs().max())
        res["logits_abs"] = float((la - lb).abs().max())
        return res

    gaps = {"kernel_vs_naive_f32": gap(("float32", "kernel"),
                                       ("float32", "naive")),
            "kernel_vs_naive_bf16": gap(("bfloat16", "kernel"),
                                        ("bfloat16", "naive")),
            "bf16_vs_f32_naive": gap(("bfloat16", "naive"),
                                     ("float32", "naive"))}
    emit("train_vs_plain", values={f"{d}.{i}": v for (d, i), v in
                                   out.items()},
         rel_gap=gaps, f32_tol=TRAIN_F32_TOL)
    per_pass = 3 * cfg.n_layers     # forward, then loss + remat recompute
    for (dtype, impl), v in out.items():
        want = per_pass if impl == "kernel" else 0
        check(v["launches"] == want,
              f"train {dtype} {impl}: flash_attention launched "
              f"{v['launches']} times, not {want}")
    for k in ("logits", "loss", "grad_norm"):
        check(gaps["kernel_vs_naive_f32"][k] <= TRAIN_F32_TOL,
              f"train f32: kernel vs naive attention off in {k}: {gaps}")
    for k in ("logits", "grad_norm"):
        check(gaps["kernel_vs_naive_bf16"][k]
              <= gaps["bf16_vs_f32_naive"][k],
              f"train bf16: kernel vs naive attention in {k} beyond the "
              f"bf16 model's own rounding: {gaps}")
    bf16 = gaps["kernel_vs_naive_bf16"]
    loss_n = out["bfloat16", "naive"]["loss"]
    check(bf16["loss"] * loss_n <= 2 * bf16["logits_abs"],
          f"train bf16: the loss moved more than twice the largest logit "
          f"change: {gaps}")
    del params, logits
    torch.cuda.empty_cache()
    return gaps


# -- phase 7: ol4el over the LM ----------------------------------------------------

OL4EL_EDGES, OL4EL_BATCH, OL4EL_SEQ, OL4EL_ROUNDS = 2, 4, 128, 2


def ol4el_phase() -> dict:
    import math
    import torch
    from repro_torch.config import get_config
    from repro_torch.launch.train import train_ol4el

    exp = get_config("qwen3-1.7b")
    n_layers = exp.model.n_layers
    args = train_args(mode="ol4el", el_mode="sync", edges=OL4EL_EDGES,
                      batch=OL4EL_BATCH, seq=OL4EL_SEQ, steps=OL4EL_ROUNDS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: every kernel count is read around exactly this run
    reset_counts()
    t0 = time.perf_counter()
    rep = train_ol4el(exp, args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    local_steps = int(sum(r.interval for r in rep.records)) * OL4EL_EDGES
    # one evaluation before the first round, one per round, one for the
    # report; each a forward of every layer (no remat without a backward)
    evals = rep.n_aggregations + 2
    want = 2 * n_layers * local_steps + n_layers * evals
    result = {"arch": exp.model.name, "mode": "sync", "edges": OL4EL_EDGES,
              "batch": OL4EL_BATCH, "seq": OL4EL_SEQ,
              "rounds": rep.n_aggregations,
              "intervals": [r.interval for r in rep.records],
              "local_steps": local_steps, "evaluations": evals,
              "losses": [r.metric for r in rep.records],
              "final_loss": rep.final_metric,
              "consumed": rep.total_consumed,
              "reason": rep.terminated_reason, "arm_pulls": rep.arm_pulls,
              "wall_s": wall, "max_memory_allocated": peak,
              "launches": launches, "flash_launches_expected": want}
    emit("ol4el", **result)
    check(rep.n_aggregations == OL4EL_ROUNDS
          and math.isfinite(rep.final_metric),
          f"ol4el: {rep.n_aggregations} rounds, final loss "
          f"{rep.final_metric}")
    check(launches["flash_attention"] == want,
          f"ol4el: flash_attention launched {launches['flash_attention']} "
          f"times, not {want}")
    check(launches["kmeans_assign"] == 0 and launches["ssd_scan"] == 0,
          "ol4el: kmeans_assign or ssd_scan launched")
    del rep
    torch.cuda.empty_cache()
    return {"flash_attention": launches["flash_attention"]}


# -- phase 8: times and bounds ------------------------------------------------

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


def kmeans_batched_timing(e: int, n: int, d: int, k: int) -> dict:
    """The batched entry at the compiled round's local-step shape beside
    ``e`` launches of the single entry on the same inputs, the plain
    version and the library's batched ``cdist`` + ``min``."""
    import torch
    from repro_torch.kernels.kmeans_assign import ops, ref
    x, c = km_batched_inputs(e, n, d, k, "float32", seed=8)
    nbytes = e * ((n * d + k * d) * 4 + n * (4 + 4))
    flops = e * (2 * n * k * d + 2 * n * d + 2 * k * d + 3 * n * k)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    out = {"e": e, "n": n, "d": d, "k": k}
    for key, fn in (
            ("", lambda: ops.assign_with_dist_batched(x, c)),
            ("singles_", lambda: [ops.assign_with_dist(x[i], c[i])
                                  for i in range(e)]),
            ("plain_", lambda: ref.assign_ref(x, c)),
            ("library_", lambda: torch.cdist(x, c).min(-1))):
        out[key + "ms"] = cuda_ms(fn, queued=True)       # the card's time
        out[key + "call_ms"] = cuda_ms(fn)               # host enqueue incl.
    out.update(bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=nbytes, flops=flops)
    return out


def ssd_timing(b, s, h, p, n, chunk, dtype_name) -> dict:
    """The kernel's card time at one shape beside its plain version's and
    its bound (bf16 operations at the tensor cores' rate, f32 at the CUDA
    cores', as each instance runs).  No single PyTorch call computes the
    SSD scan, so there is no library time."""
    import torch
    from repro_torch.kernels.ssd_scan import kernel, ops, ref
    x, da, bm, cm = ssd_inputs(b, s, h, p, n, dtype_name, seed=11)
    e = x.element_size()
    # each input read once, each output written once
    nbytes = (2 * b * s * h * p * e + b * s * h * 4 + 2 * b * s * n * e
              + b * h * p * n * 4)
    # what the function needs, as multiply-adds (2 operations each), on
    # the causal triangle of the L x L terms only: G = C B^T is shared by
    # the heads, once per (b, chunk) (2 tri N); per (b, h, chunk) the
    # masked Gd X (2 tri P), C state^T and the state update (2LPN each)
    tri = chunk * (chunk + 1) // 2
    n_chunks = s // chunk
    flops = b * n_chunks * 2 * tri * n \
        + b * h * n_chunks * (2 * tri * p + 4 * chunk * p * n)
    peak = H100_BF16_FLOPS if x.dtype == torch.bfloat16 else H100_F32_FLOPS
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / peak
    out = {"b": b, "s": s, "h": h, "p": p, "n": n, "chunk": chunk,
           "dtype": dtype_name, "p_tile": kernel.p_tile(
               b, h, p, n, chunk, x.dtype, kernel.max_smem(0),
               kernel.sm_count(0))}
    for key, fn, iters in (
            ("", lambda: ops.ssd(x, da, bm, cm, chunk), 50),
            ("plain_", lambda: ref.ssd_reference(x, da, bm, cm, chunk), 20)):
        out[key + "ms"] = cuda_ms(fn, iters=iters, warmup=5, queued=True)
        out[key + "call_ms"] = cuda_ms(fn, iters=iters, warmup=5)
    out.update(bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=nbytes, flops=flops, library_ms=None)
    return out


def flash_timing(b, s, h, kv, d, window, dtype_name) -> dict:
    """The kernel's card time at one shape beside its plain version's, the
    library's (SDPA; timed here as a yardstick, never called by the port)
    and its bound (bf16 operations at the tensor cores' rate, f32 at the
    CUDA cores', as each instance runs)."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    q, k, v = flash_inputs(b, s, h, kv, d, dtype_name, seed=13)
    e = q.element_size()
    # q, k, v read once, o written once
    nbytes = (2 * b * s * h * d + 2 * b * s * kv * d) * e
    # QK^T and PV on the causal triangle (window 0): 2 x 2 B H D S(S+1)/2
    flops = 4 * b * h * d * s * (s + 1) // 2
    peak = H100_BF16_FLOPS if q.dtype == torch.bfloat16 else H100_F32_FLOPS
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / peak
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))     # [B, H, S, D]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {"b": b, "s": s, "h": h, "kv": kv, "d": d, "window": window,
           "dtype": dtype_name}
    for key, fn, iters in (
            ("", lambda: ops.flash_attention(q, k, v, window=window), 50),
            ("plain_", lambda: ref.attention_ref(q, k, v, window=window), 20),
            ("library_", lambda: sdpa(qt, kt, vt, is_causal=True,
                                      enable_gqa=True), 50)):
        out[key + "ms"] = cuda_ms(fn, iters=iters, warmup=5, queued=True)
        out[key + "call_ms"] = cuda_ms(fn, iters=iters, warmup=5)
    out.update(bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=nbytes, flops=flops)
    return out


def sass_census(library: Path, kernel: str, params: tuple) -> dict:
    """Tensor-core instructions in each instance of a kernel's SASS
    (``cuobjdump -sass`` on the built library): HMMA is ``mma.sync``,
    HGMMA ``wgmma``.  Functions are named ``<kernel>_<instance>`` with int
    template arguments named by ``params``, keyed as
    ``instance<param=value,...>``."""
    from repro_torch.kernels import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(library)],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr.strip()}")
    census, name = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            m = re.search(rf"{kernel}_(\w+?)(?:I((?:Li\d+E)+)E|E|$)", line)
            name = None
            if m:
                args = re.findall(r"Li(\d+)E", m.group(2) or "")
                name = m.group(1) + (
                    "<" + ",".join(f"{p}={a}" for p, a in zip(params, args))
                    + ">" if args else "")
                census[name] = {"HMMA": 0, "HGMMA": 0}
        elif name:
            op = re.search(r"\b(HGMMA|HMMA)\.", line)
            if op:
                census[name][op.group(1)] += 1
    return census


def build_all() -> None:
    """Compile every kernel's source at once (one nvcc each), then load."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.kmeans_assign import kernel as ka_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    kernels = {"kmeans_assign": ka_kernel, "ssd_scan": ssd_kernel,
               "flash_attention": fa_kernel}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
        paths = dict(zip(kernels, pool.map(lambda k: k.library_path(),
                                           kernels.values())))
    seconds = time.perf_counter() - t0
    census = sass_census(paths["flash_attention"], "flash_attention_kernel",
                         ("D",))
    ssd_census = sass_census(paths["ssd_scan"], "ssd_scan_kernel",
                             ("Pt", "items"))
    # ptxas reports static shared memory only; these two use dynamic
    extra = {"ssd_scan": {
        "dynamic_smem_bytes_at_P64_N128_L128": {
            "float32": ssd_kernel.smem_bytes(64, 128, 128, torch.float32),
            "bfloat16": {f"Pt={t}": ssd_kernel.smem_bytes(
                64, 128, 128, torch.bfloat16, t) for t in (32, 64)}},
        "dynamic_smem_limit": ssd_kernel.max_smem(0),
        "sass_tensor_core_instructions": ssd_census},
        "flash_attention": {
        "dynamic_smem_bytes": {
            str(dt).removeprefix("torch."): {
                f"D={d}": fa_kernel.smem_bytes(d, dt)
                for d in fa_kernel.HEAD_DIMS}
            for dt in (torch.bfloat16, torch.float32)},
        "dynamic_smem_limit": fa_kernel.max_smem(0),
        "sass_tensor_core_instructions": census}}
    for name, mod in kernels.items():
        mod.library()
        log_path = paths[name].with_suffix(".log")
        log = log_path.read_text() if log_path.exists() else ""
        emit("build", kernel=name, seconds=seconds,
             library=str(paths[name].relative_to(ROOT)),
             ptxas=[ln.strip() for ln in log.splitlines()
                    if ("ptxas info" in ln or "spill" in ln)
                    and "Compile time" not in ln],
             **extra.get(name, {}))
    for d in fa_kernel.HEAD_DIMS:
        counts = census.get(f"bf16<D={d}>", {})
        check(counts.get("HMMA", 0) + counts.get("HGMMA", 0) > 0,
              f"flash_attention bf16 at D={d}: no tensor-core instruction "
              f"in its SASS: {census}")
    bf16 = {k: v for k, v in ssd_census.items() if k.startswith("bf16<")}
    check(len(bf16) == 3 * len(ssd_kernel.P_TILES)
          and all(v["HMMA"] > 0 for v in bf16.values()),
          f"ssd_scan: a bf16 instance without HMMA in its SASS: "
          f"{ssd_census}")


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

    build_all()
    km_err = kernel_vs_plain()
    kmb_err = kernel_batched_vs_plain()
    ssd_err = ssd_vs_plain()
    fa_err = flash_vs_plain()
    launches, host_s = slice_phase()
    fixtures = classic_fixtures()
    compiled = compiled_phase(host_s, fixtures)
    events = async_phase(fixtures)
    del fixtures
    launches["kmeans_assign"] += events["kmeans_assign"]
    launches["kmeans_assign_batched"] = (compiled["kmeans_assign_batched"]
                                         + events["kmeans_assign_batched"])
    launches.update(serve_phase())
    launches.update(train_phase())
    train_vs_plain()
    ol4el_phase()

    km_shapes = [kmeans_timing(*s) for s in MAIN_SHAPES]
    km = km_shapes[0]
    kmb = kmeans_batched_timing(*KM_BATCHED_MAIN)
    emit("kmeans_batched_timing", **kmb)
    ssd = ssd_timing(*SSD_MAIN)
    emit("ssd_timing", **ssd)
    ssd32 = ssd_timing(*SSD_MAIN[:-1], "float32")
    emit("ssd_timing", **ssd32)
    ssd_admit = ssd_timing(1, 128, *SSD_MAIN[2:])    # a lone admitted prompt
    emit("ssd_timing", **ssd_admit)
    fa = flash_timing(*FLASH_MAIN)
    emit("flash_timing", **fa)
    fa32 = flash_timing(*FLASH_MAIN[:-1], "float32")
    emit("flash_timing", **fa32)
    instance_keys = ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms",
                     "bound_by")

    def instances(bf16, f32):
        return {"bfloat16": {"cores": "tensor (mma.sync)",
                             **{k: bf16[k] for k in instance_keys}},
                "float32": {"cores": "CUDA (f32 FMA)",
                            **{k: f32[k] for k in instance_keys}}}
    # an empty kernel queued the same way: what a launch alone costs
    launch_floor_ms = cuda_ms(lambda: torch.cuda._sleep(0), queued=True)
    print(json.dumps({"kernels": [{
        "name": "kmeans_assign", "route": "cuda",
        "source": "src/repro_torch/csrc/kmeans_assign.cu",
        "replaces": "src/repro/kernels/kmeans_assign/kernel.py:20",
        "launches": launches["kmeans_assign"], "max_abs_err": km_err,
        "ms": km["ms"], "kernel_ms": km["ms"], "call_ms": km["call_ms"],
        "plain_ms": km["plain_ms"], "bound_ms": km["bound_ms"],
        "bound_by": km["bound_by"], "library_ms": km["library_ms"],
        "launch_floor_ms": launch_floor_ms, "shapes": km_shapes}, {
        "name": "kmeans_assign_batched", "route": "cuda",
        "source": "src/repro_torch/csrc/kmeans_assign.cu",
        "replaces": "src/repro/kernels/kmeans_assign/kernel.py:20 (under "
                    "jax.vmap, src/repro/el/ingraph.py:526)",
        "launches": launches["kmeans_assign_batched"],
        "max_abs_err": kmb_err, "ms": kmb["ms"], "kernel_ms": kmb["ms"],
        "call_ms": kmb["call_ms"], "plain_ms": kmb["plain_ms"],
        "bound_ms": kmb["bound_ms"], "bound_by": kmb["bound_by"],
        "library_ms": kmb["library_ms"],
        "library": "torch.cdist(x, c).min(-1) on [E, N, D] x [E, K, D]",
        "singles_ms": kmb["singles_ms"],
        "singles_call_ms": kmb["singles_call_ms"],
        "launch_floor_ms": launch_floor_ms, "shapes": [kmb]}, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:32",
        "launches": launches["ssd_scan"], "max_abs_err": ssd_err,
        "ms": ssd["ms"], "kernel_ms": ssd["ms"], "call_ms": ssd["call_ms"],
        "plain_ms": ssd["plain_ms"], "bound_ms": ssd["bound_ms"],
        "bound_by": ssd["bound_by"], "library_ms": None,
        "instances": instances(ssd, ssd32),
        "launch_floor_ms": launch_floor_ms,
        "shapes": [ssd, ssd32, ssd_admit]}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:30",
        "launches": launches["flash_attention"], "max_abs_err": fa_err,
        "ms": fa["ms"], "kernel_ms": fa["ms"], "call_ms": fa["call_ms"],
        "plain_ms": fa["plain_ms"], "bound_ms": fa["bound_ms"],
        "bound_by": fa["bound_by"], "library_ms": fa["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention("
                   "is_causal=True, enable_gqa=True)",
        "instances": instances(fa, fa32),
        "launch_floor_ms": launch_floor_ms, "shapes": [fa, fa32]}]}),
        flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

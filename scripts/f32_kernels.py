"""Check and time the f32 (CUDA-core) instances of ``flash_attention`` and
``ssd_scan`` on one card.

    PYTHONPATH=src python scripts/f32_kernels.py

Builds both kernels from ``src/repro_torch/csrc`` with the port's nvcc
flags and prints the ptxas registers and spills of every f32 entry. Then
holds each f32 instance against its plain version within
``ref.allowed_error`` (the rule the card tests and ``chip_smoke.py`` hold
the kernels to) at the shapes that exercise its tiles: ``flash_attention``
at ragged S (1, 63, 65, 200, 1000), windows of 1, one key tile and >= S,
non-causal, D = 64, 128 and 256 and GQA groups of 1, 2 and 8;
``ssd_scan`` at chunk 100, a single chunk, 16 chunks, P = N = 128,
P = 32 with N = 16, B * H = 1, an all-zero ``da``, P and N that are not
multiples of 4, and a ``da`` whose decays underflow. Last it times the
rows ``chip_smoke.py`` phase 8 reports for the f32 instances (and the bf16
instances at the same shapes beside them) with ``chip_smoke``'s own
timing functions: the kernel queued and as called, the plain version,
SDPA where one call computes the same function, and the bound from the
unchanged ``ops.work``. One JSON line per case and per row, then the
card's name and power limit. Needs a card and nvcc; exits non-zero if a
case is off.

    PYTHONPATH=src python scripts/f32_kernels.py --variants

instead builds each entry of ``VARIANTS`` (the source with edits applied
to its text; the script fails if an edit no longer applies) into
``build/f32_variants/``, prints its ptxas registers and spills, launches
it through its C entry point at the phase-8 f32 shapes and prints its
time (queued, ``chip_smoke.cuda_ms``) and how many elements lie beyond
``ref.allowed_error``, the source as built timed first and again last so
the spread shows. An ablation (a phase cut out) is wrong by design: its
time says what the phase costs.
"""

from __future__ import annotations

import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# (b, s, h, kv, d, window, causal)
FLASH_CASES = [
    (2, 1, 4, 2, 128, 0, True), (2, 63, 4, 2, 128, 0, True),
    (2, 65, 4, 2, 128, 0, True), (1, 200, 4, 2, 128, 0, True),
    (1, 1000, 4, 2, 128, 0, True),
    (1, 300, 4, 2, 128, 1, True), (1, 300, 4, 2, 128, 64, True),
    (1, 300, 4, 2, 128, 300, True), (1, 300, 4, 2, 128, 512, True),
    (1, 300, 4, 2, 128, 0, False), (2, 200, 4, 1, 64, 100, False),
    (2, 300, 4, 4, 64, 0, True), (1, 300, 8, 1, 64, 0, True),
    (2, 300, 8, 4, 256, 0, True), (1, 200, 8, 1, 256, 64, True),
    (1, 300, 2, 2, 256, 0, False), (1, 257, 16, 2, 128, 0, True),
    (8, 512, 16, 8, 128, 0, True),
]
# (b, s, h, p, n, chunk, da scale): 0 makes every decay exactly 1
SSD_CASES = [
    (2, 100, 4, 64, 128, 100, 1.0), (1, 128, 4, 32, 16, 128, 1.0),
    (1, 2048, 2, 64, 128, 128, 1.0), (1, 384, 2, 128, 128, 128, 1.0),
    (3, 64, 4, 32, 16, 32, 1.0), (1, 256, 1, 64, 128, 128, 1.0),
    (2, 256, 4, 64, 128, 128, 0.0), (1, 128, 4, 32, 16, 128, 200.0),
    (2, 96, 3, 40, 24, 48, 1.0), (1, 90, 2, 30, 18, 45, 1.0),
    (1, 128, 2, 32, 256, 64, 1.0), (2, 128, 3, 200, 64, 64, 1.0),
    (4, 512, 32, 64, 128, 128, 1.0), (4, 512, 128, 128, 128, 128, 1.0),
]


# kernel source -> {variant: [(old, new), ...]}
VARIANTS = {
    "flash_attention.cu": {
        "as_built": [],
        # thread tiles of 8 rows x 8 keys on 128-key tiles (2 row groups
        # of 16 lanes): 16 floats loaded per 64 FMAs of QK^T
        "rows8_keys128": [
            ("  static constexpr int kRowGroups = 4;",
             "  static constexpr int kRowGroups = D > 128 ? 4 : 2;"),
            ("  static constexpr int kRows = D > 128 ? 2 : 4;",
             "  static constexpr int kRows = D > 128 ? 2 : 8;"),
            ("  static constexpr int kBlockK = 64;",
             "  static constexpr int kBlockK = D > 128 ? 64 : 128;")],
        # 4 rows x 16 keys on 128-key tiles: 20 floats per 64 FMAs
        "keys128": [("  static constexpr int kBlockK = 64;",
                     "  static constexpr int kBlockK = D > 128 ? 64 : 128;")],
        # blocks of 4 warps, 64 query rows (two blocks an SM): less of the
        # causal diagonal's masked half
        "warps4": [("  static constexpr int kWarps = 8;",
                    "  static constexpr int kWarps = 4;")],
        # warps whose 16 rows all lie before a causal tile skip it
        "warp_skip": [
            ("    float s[kR][kNK];\n",
             "    const bool live = !causal ||\n"
             "        q0 + (warp + 1) * kRG * kR - 1 >= k0;\n"
             "    float s[kR][kNK];\n"),
            ("    for (int d = 0; d < D; d += 2) {",
             "    for (int d = 0; d < (live ? D : 0); d += 2) {"),
            ("    if (need_mask)\n      softmax_update",
             "    if (!live) {\n    } else if (need_mask)\n"
             "      softmax_update"),
            ("    // O += P V: key kKG j + g",
             "    if (live)\n    // O += P V: key kKG j + g")],
        # the QK^T loop unrolled 1 or 2 steps of 2 instead of 4
        "unroll1": [("#pragma unroll 4\n    for (int d = 0; d < D; d += 2)",
                     "#pragma unroll 1\n    for (int d = 0; d < D; d += 2)")],
        "unroll2": [("#pragma unroll 4\n    for (int d = 0; d < D; d += 2)",
                     "#pragma unroll 2\n    for (int d = 0; d < D; d += 2)")],
    },
    "ssd_scan.cu": {
        "as_built": [],
        # every warp forms G for all 8 column blocks (balanced, twice the
        # work; valid at L = 128 only)
        "gram_square": [("    if (live) gram_rows<W + 1>",
                         "    if (live) gram_rows<8>")],
        # (a) reads y's diagonal part where it adds to it, not before its
        # product (32 registers fewer across the loop)
        "a_y_late": [
            ("          yv[r][e] = i < chunk && p < p_cols\n"
             "                         ? y[(t0 + i) * x_step + (long long)h * "
             "p_dim + p0 + p]\n                         : 0.f;",
             "          yv[r][e] = 0.f;"),
            ("fmaf(e_cs[i], acc[r][e], yv[r][e]);",
             "fmaf(e_cs[i], acc[r][e], y[(t0 + i) * x_step + (long long)h "
             "* p_dim + p0 + p]);")],
        # ablations, wrong by design: one phase cut out
        "carry_no_a": [("    if (ic > 0) {                          // (a)",
                        "    if (false) {                           // (a)")],
        "carry_no_b": [
            ("    for (int l = 0; l < lp; ++l) {\n      const float4 xv",
             "    for (int l = 0; l < 0; ++l) {\n      const float4 xv")],
        "diag_no_g": [("    if (live) gram_rows<W + 1>",
                       "    if (false) gram_rows<W + 1>")],
        "diag_no_gdx": [("      for (int j = 0; j < j_end; j += 4) {",
                         "      for (int j = 0; j < 0; j += 4) {")],
        "diag_no_exp": [("? g[i * gs + j] * expf(ac[i] - ac[j])",
                         "? g[i * gs + j]")],
    },
}


def ptxas_f32(log: str) -> list:
    """(function, registers, spill stores, spill loads) of each f32 entry
    in an nvcc ``-Xptxas -v`` log."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1) if "f32" in m.group(1) else None
            spills = None
        elif name and "spill stores" in line:
            spills = [int(v) for v in re.findall(r"(\d+) bytes spill", line)]
        elif name and "Used" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            out.append((name, regs, *spills))
            name = None
    return out


def kernel_times(fn, iters: int = 10) -> dict:
    """Mean device microseconds of each kernel ``fn`` launches, by
    ``torch.profiler`` over ``iters`` calls after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    out = {}
    for e in prof.events():
        if e.device_type == cuda:
            out[e.name] = out.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / iters
    return out


def build_variants() -> dict:
    """Build every variant at once (one nvcc each); {(source, name): lib}."""
    from repro_torch.kernels import _build
    out_dir = ROOT / "build" / "f32_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for source, variants in VARIANTS.items():
        text0 = (_build.CSRC / source).read_text()
        for name, edits in variants.items():
            text = text0
            for old, new in edits:
                if text.count(old) != 1:
                    raise SystemExit(f"{name}: edit no longer applies: "
                                     f"{old!r}")
                text = text.replace(old, new)
            cu = out_dir / f"{Path(source).stem}_{name}.cu"
            cu.write_text(text)
            procs[source, name] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                 str(cu.with_suffix(".so")), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (source, name), proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{source} {name}: build failed:\n{log}")
        print(json.dumps({"variant": f"{source}:{name}", "ptxas": [
            list(r) for r in ptxas_f32(log)]}), flush=True)
        libs[source, name] = ctypes.CDLL(
            str(out_dir / f"{Path(source).stem}_{name}.so"))
    return libs


def run_variants() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.device import resolve_device
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    resolve_device("cuda")
    libs = build_variants()
    vp, ci = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    for shape in (cs.FLASH_MAIN[:-1], cs.FLASH_RING[:-1]):
        b, s, h, kv, d, window = shape
        q, k, v = cs.flash_inputs(b, s, h, kv, d, "float32", seed=13)
        o = torch.empty_like(q)
        want, allowed = fa_ref.allowed_error(q, k, v, window=window)
        row = {"flash_f32": list(shape)}
        names = [n for src, n in libs if src == "flash_attention.cu"]
        for name in names + ["as_built"]:
            lib = libs["flash_attention.cu", name]
            lib.flash_attention_launch.argtypes = [
                vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ctypes.c_float,
                ci, vp]

            def launch(lib=lib):
                err = lib.flash_attention_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    b, s, h, kv, d, 1, window, 1.0 / math.sqrt(d), 0, stream)
                if err:
                    raise SystemExit(f"{name}: CUDA error {err}")
            o.zero_()
            launch()
            torch.cuda.synchronize()
            key = name if name not in row else name + "_again"
            row[key] = {"ms": cs.cuda_ms(launch, iters=20 if s > 4096
                                         else 100, warmup=3, queued=True),
                        "beyond": int(((o.double() - want).abs()
                                       > allowed).sum())}
        del want, allowed
        torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
    for shape in (cs.SSD_MAIN[:-1], cs.SSD_JAMBA[:-1]):
        b, s, h, p, n, chunk = shape
        x, da, bm, cm = cs.ssd_inputs(b, s, h, p, n, "float32", seed=11)
        y = torch.empty_like(x)
        st = torch.empty(b, h, p, n, device="cuda")
        hg = ssd_kernel.f32_heads_per_block(b, s, h, p, n, chunk,
                                            ssd_kernel.sm_count(0))
        (yw, ya), (sw, sa) = ssd_ref.allowed_error(x, da, bm, cm, chunk)
        row = {"ssd_f32": list(shape), "heads_per_block": hg}
        names = [nm for src, nm in libs if src == "ssd_scan.cu"]
        for name in names + ["as_built"]:
            lib = ssd_kernel.declare(libs["ssd_scan.cu", name])

            def launch(lib=lib):
                err = lib.ssd_scan_launch(
                    x.data_ptr(), da.data_ptr(), bm.data_ptr(),
                    cm.data_ptr(), b, s, h, p, n, chunk, 0, 0, hg,
                    y.data_ptr(), st.data_ptr(), None, 0, stream)
                if err:
                    raise SystemExit(f"{name}: CUDA error {err}")
            launch()
            torch.cuda.synchronize()
            key = name if name not in row else name + "_again"
            row[key] = {
                "ms": cs.cuda_ms(launch, iters=50, warmup=5, queued=True),
                "beyond": int(((y.double() - yw).abs() > ya).sum()
                              + ((st.double() - sw).abs() > sa).sum())}
        print(json.dumps(row), flush=True)
    print(cs.card_line(), flush=True)
    return 0


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.device import resolve_device
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    if not torch.cuda.is_available():
        print("f32_kernels: no card", file=sys.stderr)
        return 1
    resolve_device("cuda")
    bad = 0
    for mod in (fa_kernel, ssd_kernel):
        path = mod.library_path()
        for name, regs, st, ld in ptxas_f32(
                path.with_suffix(".log").read_text()):
            print(json.dumps({"ptxas": name, "registers": regs,
                              "spill_stores": st, "spill_loads": ld}),
                  flush=True)
    for b, s, h, kv, d, window, causal in FLASH_CASES:
        q, k, v = cs.flash_inputs(b, s, h, kv, d, "float32",
                                  seed=s + h + d + window)
        out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want, allowed = fa_ref.allowed_error(q, k, v, causal=causal,
                                             window=window)
        err = (out.double() - want).abs()
        ok = bool(torch.isfinite(out).all()) and bool((err <= allowed).all())
        bad += not ok
        print(json.dumps({"flash_f32": [b, s, h, kv, d, window, causal],
                          "ok": ok, "max_abs_err": float(err.max()),
                          "beyond": int((err > allowed).sum())}),
              flush=True)
    for b, s, h, p, n, chunk, scale in SSD_CASES:
        x, da, bm, cm = cs.ssd_inputs(b, s, h, p, n, "float32",
                                      seed=s * h + p)
        da = da * scale
        y, state = ssd_ops.ssd(x, da, bm, cm, chunk)
        torch.cuda.synchronize()
        row = {"ssd_f32": [b, s, h, p, n, chunk, scale]}
        ok = True
        for key, got, (want, allowed) in zip(
                ("y", "state"), (y, state),
                ssd_ref.allowed_error(x, da, bm, cm, chunk)):
            err = (got.double() - want).abs()
            ok &= bool(torch.isfinite(got).all()) \
                and bool((err <= allowed).all())
            row[key + "_max_abs_err"] = float(err.max())
            row[key + "_beyond"] = int((err > allowed).sum())
        bad += not ok
        print(json.dumps({**row, "ok": ok}), flush=True)
    for shape in (cs.SSD_MAIN[:-1], cs.SSD_JAMBA[:-1]):
        x, da, bm, cm = cs.ssd_inputs(*shape[:5], "float32", seed=11)
        print(json.dumps({"ssd_f32_kernels_us": list(shape), **kernel_times(
            lambda: ssd_ops.ssd(x, da, bm, cm, shape[-1]))}), flush=True)
    for shape in (cs.FLASH_MAIN[:-1], cs.FLASH_RING[:-1]):
        for dt in ("float32", "bfloat16"):
            print(json.dumps({"flash_timing": cs.flash_timing(*shape, dt)}),
                  flush=True)
    for shape in (cs.SSD_MAIN[:-1], cs.SSD_JAMBA[:-1]):
        for dt in ("float32", "bfloat16"):
            print(json.dumps({"ssd_timing": cs.ssd_timing(*shape, dt)}),
                  flush=True)
    print(cs.card_line(), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(run_variants() if "--variants" in sys.argv[1:] else main())

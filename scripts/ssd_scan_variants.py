"""Time design variants of the bf16 (tensor-core) ``ssd_scan`` kernel.

    PYTHONPATH=src python scripts/ssd_scan_variants.py

Each build is ``src/repro_torch/csrc/ssd_scan.cu`` with edits applied to
its text (the script fails if an edit no longer applies):

- ``as_built``: the source as it is: each scan block forms its 16 x 16
  tiles of G = C B^T from the staged C and B, and every f32 operand of a
  product is split into a hi and a lo bf16 part;
- ``shared_g``: G formed once per (batch row, chunk) by a kernel of its
  own into an f32 buffer that the scan blocks read, each row tile's next
  G tile in flight while one is used (one launch more, ~2.4 MFLOP less
  per (b, h, chunk));
- ``bf16_rounding``: the lo parts dropped, each f32 operand rounded once
  to bf16 (one mma.sync per product instead of two).

``as_built`` and ``shared_g`` run at a P tile of P and of P / 2,
``bf16_rounding`` at the tile the wrapper plans; ``op_ms`` times the op as
the model calls it.  All builds are made at once with the port's nvcc
flags into ``build/ssd_scan_variants/`` (ptxas registers and spills
printed).  Each variant is launched through the C entry point on bf16
inputs at the serving prefill's shape and a few others, held against
``ref.allowed_error`` (the rule the card tests hold the kernel to) and
timed with CUDA events, queued, as ``chip_smoke.py`` times kernels, with
the first variant timed again last so the spread shows.  Then, for the
rounding variant and for ``as_built``, mamba2-370m at full width is
prefilled with kernel and plain SSD through all 48 layers, as
``chip_smoke.py``'s serve phase does, and ``kernel_vs_plain_bf16`` is
printed beside ``bf16_vs_f32_plain``.  Prints one JSON line per shape and
per through-model pass, then the card's name and power limit.  Needs a
card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

GRAM_KERNEL = """\
// shared_g: G = C B^T on the causal triangle's 16 x 16 tiles, one block
// per (b, chunk), into g_gram [B * n_chunks, Lp, Lp] f32 (tiles above the
// diagonal are not written; the scan never reads them)
__device__ float* g_gram;
float* h_gram = nullptr;

__global__ void __launch_bounds__(kThreads)
    ssd_gram_kernel_bf16(const __nv_bfloat16* __restrict__ bm,
                         const __nv_bfloat16* __restrict__ cm, int n_dim,
                         int chunk, float* __restrict__ gram) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lp = (chunk + 15) / 16 * 16;
  const int ns = n_dim + kPad;
  const uint32_t cs = smem_addr(smem_raw);
  const uint32_t bs = cs + lp * ns * 2;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const long long t0 = (long long)blockIdx.x * chunk;
  load_rows(cs, cm + t0 * n_dim, n_dim, lp, n_dim, ns, chunk, tid);
  load_rows(bs, bm + t0 * n_dim, n_dim, lp, n_dim, ns, chunk, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float* out = gram + (long long)blockIdx.x * lp * lp;
  const int mt = lp / 16;
  for (int t = warp; t < mt * (mt + 1) / 2; t += kWarps) {
    int rt = 0;
    while ((rt + 1) * (rt + 2) / 2 <= t) ++rt;
    const int kt = t - rt * (rt + 1) / 2;
    float gv[2][4];
    gram_tile<__nv_bfloat16>(gv, cs, bs, ns, n_dim, rt * 16, kt * 16,
                             lane);
    for (int e = 0; e < 2; ++e) {
      float* row = out + (rt * 16 + g) * lp + kt * 16 + 8 * e + 2 * tig;
      *reinterpret_cast<float2*>(row) = make_float2(gv[e][0], gv[e][1]);
      *reinterpret_cast<float2*>(row + 8 * lp) =
          make_float2(gv[e][2], gv[e][3]);
    }
  }
}

"""
LOAD_G = """\
      const float* gb = g_gram + ((long long)b * n_chunks + ic) * lp * lp;
      auto load_g = [&](float (&gv)[2][4], int j0) {
        for (int e = 0; e < 2; ++e) {
          const float* gr = gb + r0 * lp + j0 + 8 * e + 2 * tig;
          const float2 u = *reinterpret_cast<const float2*>(gr);
          const float2 v = *reinterpret_cast<const float2*>(gr + 8 * lp);
          gv[e][0] = u.x; gv[e][1] = u.y; gv[e][2] = v.x; gv[e][3] = v.y;
        }
      };
      float g_next[2][4];
      load_g(g_next, 0);
"""
EDITS = {
    "as_built": [],
    "shared_g": [
        ("// The scan block's body, for T",
         GRAM_KERNEL + "// The scan block's body, for T"),
        ("      float acc[kNT][4];\n", LOAD_G + "      float acc[kNT][4];\n"),
        ("        gram_tile<T>(gv, cs_a, bs_a, ns, n_dim, i0, j0, lane);\n",
         "        for (int e = 0; e < 2; ++e)\n"
         "          for (int q = 0; q < 4; ++q) gv[e][q] = g_next[e][q];\n"
         "        if (kt < rt) load_g(g_next, j0 + 16);\n"),
        ("    return (int)cudaErrorInvalidValue;\n  switch (p_tile) {",
         "    return (int)cudaErrorInvalidValue;\n"
         "  if constexpr (std::is_same_v<T, __nv_bfloat16>) {\n"
         "    const int smem = 2 * ((a.chunk + 15) / 16 * 16) * "
         "(a.n_dim + tc::kPad) * 2;\n"
         "    if (int err = set_smem(tc::ssd_gram_kernel_bf16, smem)) "
         "return err;\n"
         "    tc::ssd_gram_kernel_bf16<<<a.batch * (a.seqlen / a.chunk), "
         "tc::kThreads, smem, a.stream>>>(a.bm, a.cm, a.n_dim, a.chunk, "
         "tc::h_gram);\n"
         "    if (int err = (int)cudaGetLastError()) return err;\n"
         "  }\n"
         "  switch (p_tile) {"),
        ("}  // extern \"C\"",
         "// the G buffer the scan blocks read\n"
         "int ssd_scan_set_gram(void* gram) {\n"
         "  tc::h_gram = static_cast<float*>(gram);\n"
         "  return (int)cudaMemcpyToSymbol(tc::g_gram, &tc::h_gram,\n"
         "                                 sizeof(tc::h_gram));\n"
         "}\n\n}  // extern \"C\"")],
    "bf16_rounding": [
        ("  lo = pack<T>(a - hf.x, b - hf.y);", "  lo = 0u;"),
        ("  mma<T>(c, hi, b0, b1);\n  mma<T>(c, lo, b0, b1);",
         "  mma<T>(c, hi, b0, b1);"),
        ("            ldmatrix_x4(bl, lo_a + off);\n", ""),
        ("            mma<T>(acc[2 * dp], a, bl[0], bl[1]);\n"
         "            mma<T>(acc[2 * dp + 1], a, bl[2], bl[3]);\n", "")],
}
# (b, s, h, p, n, chunk): the serving prefill first, then a lone admitted
# prompt, the mid-flight wave padded to 640, and P = N = 128
SHAPES = [(4, 512, 32, 64, 128, 128), (1, 128, 32, 64, 128, 128),
          (4, 640, 32, 64, 128, 128), (2, 256, 8, 128, 128, 128)]


def build() -> dict:
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import kernel
    out_dir = ROOT / "build" / "ssd_scan_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "ssd_scan.cu").read_text()
    procs = {}
    for name, edits in EDITS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: edit no longer applies: {old!r}")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
               str(cu.with_suffix(".so")), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: build failed:\n{log}")
        ptxas, label = {}, None
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function .*ssd_(\w+?)_kernel_"
                          r"(\w+?)(?:I((?:Li\d+E)+)E|E)", ln)
            if m:
                args = re.findall(r"Li(\d+)E", m.group(3) or "")
                label = f"{m.group(1)}_{m.group(2)}" + (
                    "<Pt={},items={}>".format(*args) if args else "")
            elif label and ("Used" in ln or "spill" in ln):
                ptxas.setdefault(label, []).append(
                    ln.replace("ptxas info    :", "").strip())
        print(json.dumps({"build": name, "ptxas": ptxas}), flush=True)
        lib = kernel.declare(ctypes.CDLL(str(out_dir / f"{name}.so")))
        if name == "shared_g":
            lib.ssd_scan_set_gram.argtypes = [ctypes.c_void_p]
            lib.ssd_scan_set_gram.restype = ctypes.c_int
        libs[name] = lib
    return libs


def time_shapes(libs) -> None:
    import torch
    from chip_smoke import cuda_ms, ssd_inputs
    from repro_torch.kernels.ssd_scan import kernel, ops, ref
    limit, sms = kernel.max_smem(0), kernel.sm_count(0)
    for b, s, h, p, n, chunk in SHAPES:
        x, da, bm, cm = ssd_inputs(b, s, h, p, n, "bfloat16", seed=21)
        y = torch.empty_like(x)
        state = torch.empty(b, h, p, n, dtype=torch.float32, device="cuda")
        lp = kernel.padded_chunk(chunk)
        gram = torch.empty(b, s // chunk, lp, lp, dtype=torch.float32,
                           device="cuda")
        err = libs["shared_g"].ssd_scan_set_gram(gram.data_ptr())
        if err:
            raise SystemExit(f"setting the G buffer failed: CUDA error {err}")
        planned = kernel.plan(b, s, h, p, n, chunk, x.dtype, limit,
                              sms).p_tile
        variants = {f"pt{t}_{name}": (libs[name], t)
                    for t in (p, p // 2) for name in ("as_built", "shared_g")}
        variants["bf16_rounding"] = (libs["bf16_rounding"], planned)

        def launch(lib, tile):
            err = lib.ssd_scan_launch(
                x.data_ptr(), da.data_ptr(), bm.data_ptr(), cm.data_ptr(),
                b, s, h, p, n, chunk, 1, tile, kernel.state_items(tile, n),
                y.data_ptr(), state.data_ptr(), None, 0,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"launch failed: CUDA error {err}")

        (y_want, y_allowed), (st_want, st_allowed) = ref.allowed_error(
            x, da, bm, cm, chunk)
        row = {"b": b, "s": s, "h": h, "p": p, "n": n, "chunk": chunk,
               "planned_p_tile": planned}
        for name, (lib, tile) in variants.items():
            if kernel.smem_bytes(p, n, chunk, x.dtype, tile) > limit:
                row[name] = {"p_tile": tile, "skipped": "shared memory"}
                continue
            y.zero_()
            state.zero_()
            launch(lib, tile)
            torch.cuda.synchronize()
            y_err = (y.double() - y_want).abs()
            st_err = (state.double() - st_want).abs()
            row[name] = {
                "p_tile": tile,
                "ms": cuda_ms(lambda: launch(lib, tile), iters=100,
                              warmup=10, queued=True),
                "y_max_abs_err": float(y_err.max()),
                "state_max_abs_err": float(st_err.max()),
                "beyond_allowed": int((y_err > y_allowed).sum())
                + int((st_err > st_allowed).sum())}
        first = f"pt{p}_as_built"
        if "ms" in row[first]:
            row[f"{first}_again_ms"] = cuda_ms(
                lambda: launch(*variants[first]), iters=100, warmup=10,
                queued=True)
        row["op_ms"] = cuda_ms(lambda: ops.ssd(x, da, bm, cm, chunk),
                               iters=100, warmup=10, queued=True)
        print(json.dumps(row), flush=True)


def through_model(libs) -> None:
    """kernel vs plain SSD through mamba2-370m's 48 layers, as the serve
    phase compares them, with each build's kernel behind the op."""
    import torch
    from chip_smoke import SERVE_TRAFFIC, serve_vs_plain
    from repro_torch.config import get_config
    from repro_torch.kernels.ssd_scan import kernel
    from repro_torch.launch.serve import build as build_model
    cfg = get_config("mamba2-370m").model
    _, params, tokens = build_model(cfg, len(SERVE_TRAFFIC), 512, "cuda")
    tokens = tokens.cpu().numpy()
    prompts = [tokens[i, :n] for i, (_, n) in enumerate(SERVE_TRAFFIC)]
    built = kernel.library
    try:
        for name in ("bf16_rounding", "as_built"):
            kernel.library = lambda lib=libs[name]: lib
            rel_err, agree, flips = serve_vs_plain(cfg, params, prompts)
            held = {t: rel_err[f"kernel_vs_plain_bf16.{t}"]
                    <= rel_err[f"bf16_vs_f32_plain.{t}"]
                    for t in ("logits", "ssm", "conv")}
            print(json.dumps({"through_model": name, "rel_err": rel_err,
                              "bf16_check_holds": held,
                              "first_token_agree": agree,
                              "flips_beyond_margin": flips}), flush=True)
            torch.cuda.empty_cache()
    finally:
        kernel.library = built


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from chip_smoke import card_line
    from repro_torch.device import resolve_device
    resolve_device("cuda")                    # also turns TF32 off
    libs = build()
    time_shapes(libs)
    through_model(libs)
    print(card_line(), flush=True)


if __name__ == "__main__":
    main()

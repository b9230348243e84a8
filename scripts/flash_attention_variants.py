#!/usr/bin/env python3
"""Time design variants of the bf16 (tensor-core) ``flash_attention`` kernel.

    PYTHONPATH=src python scripts/flash_attention_variants.py

Each variant is ``src/repro_torch/csrc/flash_attention.cu`` with one edit
applied to its text (the script fails if an edit no longer applies):

- ``as_built``: the source as it is;
- ``steps16_at_d256``: softmax steps of 16 keys at D = 256 instead of 32
  (fewer logits registers against more rescales of the accumulator);
- ``diagonal_skip``: each warp skips the 16-key blocks of a tile that lie
  past its last query row (causal), by a warp-uniform ``break`` in the
  unrolled QK^T and PV loops.

All are built at once with the port's nvcc flags into
``build/flash_attention_variants/`` (ptxas registers and spills printed),
then each is launched through its own C entry point on bf16 inputs at the
training shape and a few others, held against ``ref.allowed_error`` and
timed with CUDA events (queued, as ``chip_smoke.py`` times kernels), with
``as_built`` timed again last so the spread shows.  Prints one JSON line
per shape, then the card's name and power limit.  Needs a card and nvcc.
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

EDITS = {
    "as_built": [],
    "steps16_at_d256": [(
        "constexpr int kSubK = D > 128 ? 32 : 64;",
        "constexpr int kSubK = D > 128 ? 16 : 64;")],
    "diagonal_skip": [
        ("      // S = Q K^T, [16, kSubK] per warp",
         "      const int n16 = causal ? min(kSubK / 16, max(0, (q0 + warp * "
         "16 + 15 - k0) / 16 + 1)) : kSubK / 16;\n"
         "      // S = Q K^T, [16, kSubK] per warp"),
        ("        for (int jp = 0; jp < kNT / 2; ++jp) {\n",
         "        for (int jp = 0; jp < kNT / 2; ++jp) {\n"
         "          if (jp >= n16) break;\n"),
        ("      for (int kk = 0; kk < kSubK / 16; ++kk) {\n",
         "      for (int kk = 0; kk < kSubK / 16; ++kk) {\n"
         "        if (kk >= n16) break;\n")],
}
# (b, s, h, kv, d, window, causal): the training shape first
SHAPES = [(8, 512, 16, 8, 128, 0, True), (4, 512, 8, 1, 256, 0, True),
          (2, 300, 8, 2, 256, 64, True), (2, 300, 16, 2, 128, 100, True),
          (1, 300, 4, 2, 128, 0, False), (2, 512, 8, 4, 64, 0, True)]


def build() -> dict:
    from repro_torch.kernels import _build
    out_dir = ROOT / "build" / "flash_attention_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "flash_attention.cu").read_text()
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
            m = re.search(r"Compiling entry function .*flash_attention_"
                          r"kernel_(\w+?)ILi(\d+)E", ln)
            if m:
                label = f"{m.group(1)}<D={m.group(2)}>"
            elif label and ("Used" in ln or "spill" in ln):
                ptxas.setdefault(label, []).append(
                    ln.replace("ptxas info    :", "").strip())
        print(json.dumps({"variant": name, "ptxas": ptxas}), flush=True)
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci,
                                               ci, ci, ci, ci,
                                               ctypes.c_float, ci, vp]
        lib.flash_attention_launch.restype = ci
        libs[name] = lib
    return libs


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from chip_smoke import card_line, cuda_ms
    from repro_torch.kernels.flash_attention import ref
    libs = build()
    g = torch.Generator(device="cuda").manual_seed(0)
    for b, s, h, kv, d, window, causal in SHAPES:
        q, k, v = (torch.randn(b, s, n, d, generator=g, device="cuda")
                   .bfloat16() for n in (h, kv, kv))
        o = torch.empty_like(q)

        def launch(lib):
            err = lib.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s,
                h, kv, d, int(causal), window, 1.0 / math.sqrt(d), 1,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"launch failed: CUDA error {err}")

        want, allowed = ref.allowed_error(q, k, v, causal=causal,
                                          window=window)
        row = {"b": b, "s": s, "h": h, "kv": kv, "d": d, "window": window,
               "causal": causal}
        for name, lib in libs.items():
            o.zero_()
            launch(lib)
            torch.cuda.synchronize()
            beyond = int(((o.double() - want).abs() > allowed).sum())
            row[name] = {"ms": cuda_ms(lambda: launch(lib), iters=100,
                                       warmup=10, queued=True),
                         "beyond_allowed": beyond}
        row["as_built_again_ms"] = cuda_ms(lambda: launch(libs["as_built"]),
                                           iters=100, warmup=10, queued=True)
        print(json.dumps(row), flush=True)
    print(card_line(), flush=True)


if __name__ == "__main__":
    main()

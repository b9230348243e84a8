"""Serving example: batched request decoding with KV/SSM caches across
three architecture families (dense GQA, pure SSM, hybrid MoE) (port of
``examples/serve_batched.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_batched \
        [--device cpu]
"""

import argparse

from repro_torch.launch import serve

ARCHS = ("qwen3-1.7b", "mamba2-370m", "jamba-1.5-large-398b")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, required)")
    args = ap.parse_args(argv)
    device = [] if args.device is None else ["--device", args.device]
    out = {}
    for arch in ARCHS:
        print(f"\n=== {arch} (smoke variant) ===")
        out[arch] = serve.main(["--arch", arch, "--smoke", "--batch", "4",
                                "--prompt-len", "32", "--tokens", "16"]
                               + device)
    return out


if __name__ == "__main__":
    main()

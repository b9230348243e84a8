"""Quickstart: build an assigned architecture, train it a few steps, and
decode from it — the public API in ~50 lines (port of
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart \
        [--arch qwen3-1.7b] [--device cpu]
"""

import argparse

import torch

from repro_torch.config import get_smoke_config
from repro_torch.data import SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.train import init_train_state, make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, required)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. resolve an assigned architecture (its reduced smoke variant)
    exp = get_smoke_config(args.arch)
    print(f"arch={exp.model.name} family={exp.model.family} "
          f"params={exp.model.num_params() / 1e6:.1f}M device={dev}")

    # 2. build + train
    model = build_model(exp.model, device=dev)
    state = init_train_state(model, exp.train,
                             torch.Generator(device=dev).manual_seed(0))
    data = SyntheticLMData.for_model(exp.model, batch_size=4, seq_len=64)
    step = make_train_step(model, exp.train)
    losses = []
    for i in range(args.steps):
        state, metrics = step(state, data.batch(0, i, device=dev))
        losses.append(float(metrics["loss"]))
        print(f"  step {i}: loss={losses[-1]:.4f}")

    # 3. serve: prefill a prompt, decode 8 tokens greedily
    prompt = data.batch(0, 999, device=dev)["tokens"][..., :16]
    cache = model.init_cache(4, 32)
    with torch.inference_mode():
        logits, cache = model.prefill(state.params, prompt, cache)
        tok = logits[..., -1, :].argmax(-1)
        out = [tok]
        for _ in range(8):
            inp = (tok.reshape(4, exp.model.n_codebooks, 1)
                   if exp.model.n_codebooks > 1 else tok.reshape(4, 1))
            logits, cache = model.decode_step(state.params, inp, cache)
            tok = logits[..., -1, :].argmax(-1)
            out.append(tok)
    ids = [int(t.reshape(-1)[0]) for t in out]
    print("decoded ids:", ids)
    return {"losses": losses, "decoded": ids}


if __name__ == "__main__":
    main()

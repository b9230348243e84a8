"""Serving launcher: batched prefill + decode against the model's cache.

``python -m repro_torch.launch.serve --arch qwen3-1.7b --tokens 32`` (or
any other ported LM id: mamba2-370m, minicpm-2b, qwen2.5-14b,
deepseek-coder-33b, olmoe-1b-7b, deepseek-moe-16b) runs a batch of
synthetic requests end to end on the card: prefill the prompts
(attention through the CUDA ``flash_attention`` kernel, filling the KV
cache; Mamba layers through ``ssd_scan``), then decode N tokens per
request against the cache.  ``--smoke`` takes the
reduced config, ``--device cpu`` runs the plain path on the CPU.
Parameters are the port's random init from a generator seeded with 0.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.config import ModelConfig, get_config, get_smoke_config
from repro_torch.data import SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.models import build_model


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build(mc: ModelConfig, batch: int, prompt_len: int, device=None,
          seed: int = 0):
    """What every entry point of the serving path starts from: the model,
    its random parameters (a generator seeded with ``seed`` on
    ``device``) and a batch of synthetic prompts, int32 [batch,
    prompt_len]."""
    dev = resolve_device(device)
    model = build_model(mc, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    data = SyntheticLMData.for_model(mc, batch, prompt_len, seed=seed)
    return model, params, data.batch(0, 0, device=dev)["tokens"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, required)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    exp = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model, params, prompts = build(exp.model, args.batch, args.prompt_len,
                                   dev)
    cache = model.init_cache(args.batch, args.prompt_len + args.tokens + 1)
    gen = torch.Generator(device=dev).manual_seed(1)

    def sample(lg):
        lg = lg[:, -1, :]
        if args.temperature <= 0:
            return lg.argmax(-1)
        probs = torch.softmax(lg.float() / args.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, prompts, cache)
        tok = sample(logits)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        print(f"prefill: batch={args.batch} len={args.prompt_len} "
              f"({t_prefill * 1e3:.1f} ms, {dev})")
        generated = [tok]
        t0 = time.perf_counter()
        for _ in range(args.tokens):
            logits, cache = model.decode_step(params, tok[:, None], cache)
            tok = sample(logits)
            generated.append(tok)
        _sync(dev)
        dt = time.perf_counter() - t0
    print(f"decode: {args.tokens} steps x batch {args.batch} "
          f"-> {args.tokens * args.batch / dt:.1f} tok/s "
          f"({dt / max(args.tokens, 1) * 1e3:.1f} ms/step, {dev})")
    out = torch.stack(generated, dim=1).cpu()
    print("generated token ids (first request):", out[0][:16].tolist())
    return {"tokens": out, "prefill_s": t_prefill, "decode_s": dt}


if __name__ == "__main__":
    main()

"""Optimizers and LR schedules (port of ``repro.train.optimizer``).

AdamW and SGD (with or without momentum) with global-norm gradient
clipping, and three schedules: cosine, constant, and MiniCPM's
Warmup-Stable-Decay (WSD) [arXiv:2404.06395].  The arithmetic is the
reference's, op for op: update maths in f32, moments stored in
``opt_state_dtype``, the learning rate and bias corrections as f32
scalars on the device (no host read per step).

Unlike the reference's pure functions, ``clip_by_global_norm`` and
``apply_updates`` update their arguments in place (the gradients, the
parameters, AdamW's moments) and return them: at qwen3-1.7b's full width the
training state is 27.5 GB, and a functional update would hold a second
copy of it.  Callers that must keep their inputs pass copies
(``LMExecutor`` clones the global parameters for each local block).
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.config import TrainConfig
from repro_torch.interop import tree_leaves, tree_map

Params = Any


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


def lr_schedule(cfg: TrainConfig, step) -> torch.Tensor:
    """Learning rate at ``step`` (0-based; an int or a 0-d tensor), as an
    f32 0-d tensor on the step's device."""
    step = torch.as_tensor(step).float()

    def f32(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.float32, device=step.device)

    warm = f32(max(cfg.warmup_steps, 1))
    total = f32(max(cfg.total_steps, 1))
    peak = f32(cfg.peak_lr)
    floor = peak * cfg.min_lr_ratio
    warmup_lr = peak * torch.minimum(step + 1.0, warm) / warm
    if cfg.schedule == "constant":
        post = peak
    elif cfg.schedule == "wsd":
        decay_start = total * cfg.decay_start_frac
        frac = torch.clamp((step - decay_start)
                           / torch.clamp_min(total - decay_start, 1.0),
                           0.0, 1.0)
        post = peak - (peak - floor) * frac            # linear decay tail
    else:  # cosine
        frac = torch.clamp((step - warm) / torch.clamp_min(total - warm, 1.0),
                           0.0, 1.0)
        post = floor + 0.5 * (peak - floor) * (1.0 + torch.cos(math.pi
                                                               * frac))
    return torch.where(step < warm, warmup_lr, post)


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


class OptState(NamedTuple):
    step: torch.Tensor    # int32 0-d
    mu: Params            # first moment (adamw) / momentum buffer (sgd)
    nu: Params            # second moment (adamw) / unused zeros (sgd)


def init_opt_state(cfg: TrainConfig, params: Params) -> OptState:
    mdt = getattr(torch, cfg.opt_state_dtype)
    mu = tree_map(lambda p: torch.zeros_like(p, dtype=mdt), params)
    if cfg.optimizer == "sgd" and cfg.momentum == 0.0:
        # no buffers needed; keep shape-compatible empty moments
        nu = tree_map(lambda p: torch.zeros((), dtype=mdt, device=p.device),
                      params)
    else:
        # its own zeros: the moments are updated in place
        nu = tree_map(lambda p: torch.zeros_like(p, dtype=mdt), params)
    device = tree_leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    mu=mu, nu=nu)


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> Tuple[Params, torch.Tensor]:
    """Scale ``grads`` in place to a global L2 norm of at most
    ``max_norm`` (no scaling when ``max_norm <= 0``); returns them and
    their norm before clipping (f32 0-d)."""
    gnorm = torch.sqrt(sum(g.float().square().sum()
                           for g in tree_leaves(grads)))
    if max_norm <= 0:
        return grads, gnorm
    scale = torch.clamp_max(max_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    for g in tree_leaves(grads):
        g.mul_(scale)
    return grads, gnorm


def apply_updates(cfg: TrainConfig, params: Params, grads: Params,
                  opt_state: OptState
                  ) -> Tuple[Params, OptState, Dict[str, torch.Tensor]]:
    """One optimizer step, in place on ``params``, ``grads`` and the
    moments; returns ``(params, new opt state, {"lr", "grad_norm"})``."""
    grads = tree_map(lambda g: g.float(), grads)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = opt_state.step
    lr = lr_schedule(cfg, step)
    wd = cfg.weight_decay
    if cfg.optimizer == "sgd":
        mu = opt_state.mu
        if cfg.momentum > 0.0:
            # a new buffer, as the reference's: momentum * m + g is f32
            # whatever the moments' dtype
            mu = tree_map(lambda m, g: cfg.momentum * m + g, mu, grads)
            update = mu
        else:
            update = grads
        for p, u in zip(tree_leaves(params), tree_leaves(update)):
            p.copy_(p.float() - lr * (u + wd * p.float()))
        new_state = OptState(step + 1, mu, opt_state.nu)
    else:  # adamw: moments stored in opt_state_dtype; update math in f32
        b1, b2 = cfg.beta1, cfg.beta2
        t = (step + 1).float()
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        for p, m, v, g in zip(tree_leaves(params), tree_leaves(opt_state.mu),
                              tree_leaves(opt_state.nu), tree_leaves(grads)):
            m.copy_(b1 * m.float() + (1 - b1) * g)
            v.copy_(b2 * v.float() + (1 - b2) * g.square())
            mhat = m.float() / bc1
            vhat = v.float() / bc2
            u = mhat / (torch.sqrt(vhat) + 1e-8)
            u = u + wd * p.float()
            p.copy_(p.float() - lr * u)
        new_state = OptState(step + 1, opt_state.mu, opt_state.nu)
    return params, new_state, {"lr": lr, "grad_norm": gnorm}

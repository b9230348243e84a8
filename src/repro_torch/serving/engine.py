"""Batched serving engine: continuous batching over a fixed-slot cache
(port of ``repro.serving.engine``).

  * a fixed number of batch *slots*, each owning a row of the cache: of
    every attention layer's K/V (``[n_groups, slots, max_len, KV, D]``,
    ``[slots, max_len, KV, D]`` in an unstacked prefix layer or group, a
    ring of ``min(max_len, window)`` positions for a sliding-window model
    built with ``ring_cache``) and of every SSM layer's state (a hybrid
    model's group holds both);
  * waiting requests are admitted in waves into free slots (left-padded
    to a common length), prefilled as one batch, then decoded in
    lock-step; finished slots free early (EOS / max tokens) while the
    rest keep decoding, and a queued prompt that fits the slots' shared
    position is admitted into a free slot mid-flight;
  * greedy or per-slot temperature sampling, max-token / EOS termination;
  * a multi-codebook model's prompts are ``[CB, S]``: every codebook is
    sampled and decoded, the request records codebook 0's token.

The engine is host-driven (admission control is control plane); the
device work is the model's ``prefill`` and ``decode_step`` on the model's
device.  Sampling is a Gumbel-max, ``argmax(logits / t + g)``, as the
reference's ``jax.random.categorical`` is, with the Gumbel array ``g`` of
each sampling step taken through the RNG seam (``repro_torch.el.rng``):
by default from a ``torch.Generator`` seeded by ``seed`` on the model's
device, or from ``draws=``, e.g. a ``ReplayDraws`` of the reference
engine's ``jax.random`` draws, which makes its sampled tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.el.rng import TorchDraws

Params = Any


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # [S] or [CB, S] token ids
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    temperature: float = 0.0
    # filled by the engine
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _scatter_rows(live: Any, new: Any, rows: torch.Tensor,
                  axis: int) -> None:
    """Copy the slot rows ``rows`` of cache tree ``new`` into ``live`` in
    place, leaf by leaf, along the batch axis ``axis``: 1 in the stacked
    groups (after the leading ``[n_groups]``: K/V ``[n_groups, B, S_max,
    KV, D]``, SSM state ``[n_groups, B, ...]``), 0 in the unstacked
    prefix layers and in a list of unstacked groups, as the reference's
    ``scatter``.  Every leaf of an admitted row is overwritten, K/V and
    SSM state alike: the row takes the new prompt's prefilled state and
    keeps nothing of the request it held before."""
    if isinstance(live, dict):
        for k in live:
            _scatter_rows(live[k], new[k], rows, axis)
    elif isinstance(live, list):
        for a, b in zip(live, new):
            _scatter_rows(a, b, rows, axis)
    else:
        live.index_copy_(axis, rows, new.index_select(axis, rows))


class ServingEngine:
    def __init__(self, model, params: Params, n_slots: int = 4,
                 max_len: int = 512, seed: int = 0, draws=None):
        self.model = model
        self.cfg: ModelConfig = model.cfg
        self.device = model.device
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.draws = draws if draws is not None else TorchDraws(
            torch.Generator(device=self.device).manual_seed(seed))
        # one shared cache with a batch dim == n_slots; slots stay
        # position-aligned by LEFT-padding prompts at admission time
        self.cache = model.init_cache(n_slots, max_len)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.waiting: List[Request] = []
        self._last_tok: Optional[torch.Tensor] = None
        self._cur_len = 0          # shared position of every live slot

    # -- queue API -----------------------------------------------------------

    def submit(self, req: Request) -> None:
        self.waiting.append(req)

    @property
    def active(self) -> int:
        return sum(r is not None for r in self.slot_req)

    def has_work(self) -> bool:
        return bool(self.waiting) or self.active > 0

    # -- internals ------------------------------------------------------------

    def _slot_temperatures(self) -> np.ndarray:
        """Each slot samples with its own request's temperature (empty
        slots decode greedily — their tokens are discarded anyway)."""
        return np.array([r.temperature if r is not None else 0.0
                         for r in self.slot_req], np.float32)

    def _sample(self, logits: torch.Tensor,
                temperatures: np.ndarray) -> torch.Tensor:
        lg = logits[..., -1, :]                     # [B, V] or [B, CB, V]
        greedy = lg.argmax(dim=-1)
        if not np.any(temperatures > 0):
            return greedy
        # each slot's temperature, broadcast over its codebooks
        t = torch.from_numpy(temperatures).to(lg.device).reshape(
            (-1,) + (1,) * (lg.dim() - 2))
        # Gumbel-max: argmax(logits / t + g) samples softmax(logits / t)
        g = self.draws.gumbel(lg.shape, lg.device)
        sampled = (lg.float() / t.clamp_min(1e-6)[..., None] + g).argmax(-1)
        return torch.where(t <= 0, greedy, sampled)

    @staticmethod
    def _prompt_len(req: Request) -> int:
        return int(np.asarray(req.prompt).shape[-1])

    def _pad_prompt(self, req: Request, to_len: int) -> np.ndarray:
        p = np.asarray(req.prompt)
        return np.pad(p, [(0, 0)] * (p.ndim - 1)
                      + [(to_len - p.shape[-1], 0)])

    def _admit_free_slots(self, completed: List[Request]) -> None:
        """Mid-flight admission: fill free slots from the queue without
        resetting the wave.  A queued prompt joins only if it fits the
        slots' shared position (left-padded to ``_cur_len``); it is
        prefilled on a scratch cache and only the admitted slots' cache
        rows are copied into the live cache, so occupied slots' state is
        untouched.  Longer prompts stay queued until the batch drains and
        a fresh wave restarts at their length."""
        free = [s for s, r in enumerate(self.slot_req) if r is None]
        admitted: List[int] = []
        keep: List[Request] = []
        for req in self.waiting:
            if free and self._prompt_len(req) <= self._cur_len:
                slot = free.pop(0)
                self.slot_req[slot] = req
                admitted.append(slot)
            else:
                keep.append(req)
        self.waiting = keep
        if not admitted:
            return
        shape = np.asarray(self.slot_req[admitted[0]].prompt).shape
        batch = np.zeros((self.n_slots,) + shape[:-1] + (self._cur_len,),
                         np.int32)
        for slot in admitted:
            batch[slot] = self._pad_prompt(self.slot_req[slot],
                                           self._cur_len)
        scratch = self.model.init_cache(self.n_slots, self.max_len)
        logits, scratch = self.model.prefill(
            self.params, torch.from_numpy(batch).to(self.device), scratch)
        rows = torch.tensor(admitted, dtype=torch.long, device=self.device)
        # the shared position index is equal by construction (live and
        # scratch both at _cur_len); only the layers' slot rows move
        stacked = not isinstance(self.cache["groups"], list)
        _scatter_rows(self.cache["groups"], scratch["groups"], rows,
                      1 if stacked else 0)
        if "prefix_layers" in self.cache:
            _scatter_rows(self.cache["prefix_layers"],
                          scratch["prefix_layers"], rows, 0)
        tok = self._sample(logits, self._slot_temperatures())
        self._last_tok[rows] = tok[rows]
        flat = tok.cpu().numpy().reshape(self.n_slots, -1)
        for slot in admitted:
            self._append_and_check(slot, self.slot_req[slot],
                                   int(flat[slot, 0]), completed)

    def step(self) -> List[Request]:
        """Admit + decode one step. Returns requests completed this step.

        All active slots share one decode cadence.  An empty batch starts
        a fresh wave at the longest queued prompt's length (which is how
        prompts longer than the shared position eventually admit); a free
        slot takes a queued prompt that fits the shared position
        mid-flight, while the other slots keep decoding.
        """
        completed: List[Request] = []
        # admission: all slots empty -> start a fresh generation wave
        if self.active == 0 and self.waiting:
            wave = self.waiting[: self.n_slots]
            self.waiting = self.waiting[len(wave):]
            self.cache = self.model.init_cache(self.n_slots, self.max_len)
            max_prompt = max(self._prompt_len(r) for r in wave)
            prompts = [self._pad_prompt(req, max_prompt) for req in wave]
            batch = np.zeros((self.n_slots,) + prompts[0].shape, np.int32)
            for slot, (req, p) in enumerate(zip(wave, prompts)):
                self.slot_req[slot] = req
                batch[slot] = p
            logits, self.cache = self.model.prefill(
                self.params, torch.from_numpy(batch).to(self.device),
                self.cache)
            self._cur_len = max_prompt
            tok = self._sample(logits, self._slot_temperatures())
            self._last_tok = tok
            self._record(tok, completed)
            return completed

        if self.active == 0:
            return completed

        # free-slot refill before the lock-step decode
        if self.waiting and self.active < self.n_slots:
            self._admit_free_slots(completed)
            if self.active == 0:         # everything admitted finished at
                return completed         # its first token (EOS / max=1)

        # decode step for all active slots
        cb = self.cfg.n_codebooks
        inp = self._last_tok.reshape((self.n_slots, cb, 1) if cb > 1
                                     else (self.n_slots, 1))
        logits, self.cache = self.model.decode_step(self.params, inp,
                                                    self.cache)
        self._cur_len += 1
        tok = self._sample(logits, self._slot_temperatures())
        self._last_tok = tok
        self._record(tok, completed)
        return completed

    def _record(self, tok: torch.Tensor, completed: List[Request]) -> None:
        """Each live slot's new token (codebook 0's, with codebooks)."""
        flat = tok.cpu().numpy().reshape(self.n_slots, -1)
        for slot, req in enumerate(self.slot_req):
            if req is not None:
                self._append_and_check(slot, req, int(flat[slot, 0]),
                                       completed)

    def _append_and_check(self, slot: int, req: Request, t: int,
                          completed: List[Request]) -> None:
        req.output.append(t)
        if (len(req.output) >= req.max_new_tokens
                or (req.eos_id is not None and t == req.eos_id)):
            req.done = True
            completed.append(req)
            self.slot_req[slot] = None

    def run(self, max_steps: int = 10_000) -> List[Request]:
        done: List[Request] = []
        for _ in range(max_steps):
            if not self.has_work():
                break
            done += self.step()
        return done

"""The RNG seam: every random draw of the port's device loops.

The reference's compiled programs draw from ``jax.random`` keys, which
torch cannot reproduce.  So the device loops take their randomness from a
provider, never from a generator of their own:

  * the compiled sync round (``repro_torch.el.ingraph``) asks, per round
    t, for the Gumbel vector ``[K]`` of its arm selection, the minibatch
    uniforms ``[E, k, batch]`` of its local blocks and the cost-noise
    normals ``[E]``;
  * the compiled async engine (``repro_torch.el.events``) asks, per event
    t, for the same three draws for every edge (``[E, K]``, ``[E, k,
    batch]``, ``[E]``: the event's edge is known only on the device, which
    picks its row), and once per run for the initial round's
    ``init_gumbel`` ``[E, K]`` and ``init_normal`` ``[E]``;
  * the serving engine asks for one Gumbel array per sampling step
    (``gumbel``).

The loops take a chunk of items (rounds or events) ``t0 .. t0 + R - 1`` at
once, written into static buffers (``fill``) that a captured CUDA graph
reads.  An item's draws depend on its index only, never on how a caller
chunks them, so a program and its host twin, or a K-event wave and
single events, see the same draws.

``TorchDraws`` draws them from an explicit ``torch.Generator``; real runs
use it.  ``ReplayDraws`` hands out arrays made elsewhere: the parity tests
build it from ``jax.random`` key for key, so the port's loops see the
reference's draws.  A categorical draw is a Gumbel-max either way
(``jax.random.categorical(k, logits)`` is ``argmax(logits + gumbel(k))``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

#: The per-item draw buffers a chunk of R items reads, by name:
#: ``gumbel`` [R, ...K], ``uniform`` [R, ..., k, batch], ``normal`` [R, ...].
ROUND_DRAWS = ("gumbel", "uniform", "normal")

#: The async engine's initial-round draws: ``init_gumbel`` [E, K],
#: ``init_normal`` [E].
INIT_DRAWS = ("init_gumbel", "init_normal")


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """``-log(-log(u))`` in place, u uniform in [tiny, 1) (the reference's
    ``jax.random.gumbel``, which draws u from [tiny, 1))."""
    return u.log_().neg_().log_().neg_()


class TorchDraws:
    """Draws from ``generator`` (on the device the buffers live on).

    Items are drawn in blocks of ``BLOCK``, block after block, each block
    ``gumbel``, then ``uniform``, then ``normal``; so item t's draws are
    the same whatever chunks ask for them.  A run asks for its initial
    draws (``fill_init``) before any item.
    """

    BLOCK = 16

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self._blocks: Dict[int, Dict[str, torch.Tensor]] = {}
        self._drawn = 0                     # blocks drawn so far

    def _uniform_gumbel(self, buf: torch.Tensor) -> torch.Tensor:
        tiny = float(torch.finfo(torch.float32).tiny)
        return gumbel_from_uniform(buf.uniform_(tiny, 1.0,
                                                generator=self.generator))

    def _block(self, b: int, bufs: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        while self._drawn <= b:
            blk = {n: torch.empty((self.BLOCK,) + tuple(bufs[n].shape[1:]),
                                  device=bufs[n].device) for n in ROUND_DRAWS}
            self._uniform_gumbel(blk["gumbel"])
            blk["uniform"].uniform_(generator=self.generator)
            blk["normal"].normal_(generator=self.generator)
            self._blocks[self._drawn] = blk
            self._drawn += 1
        return self._blocks[b]

    def fill(self, bufs: Dict[str, torch.Tensor], t0: int) -> None:
        """Write items ``t0 .. t0 + R - 1``'s draws into ``bufs``."""
        n, size = bufs["gumbel"].shape[0], self.BLOCK
        for b in range(t0 // size, (t0 + n - 1) // size + 1):
            blk = self._block(b, bufs)
            lo, hi = max(t0, b * size), min(t0 + n, (b + 1) * size)
            for name in ROUND_DRAWS:
                bufs[name][lo - t0:hi - t0].copy_(
                    blk[name][lo - b * size:hi - b * size])
        for b in [b for b in self._blocks if b < t0 // size]:
            del self._blocks[b]             # callers never go back

    def fill_init(self, bufs: Dict[str, torch.Tensor]) -> None:
        """Write the initial round's draws into ``bufs``."""
        if self._drawn:
            raise ValueError("TorchDraws: the initial draws come before "
                             "any item's")
        self._uniform_gumbel(bufs["init_gumbel"])
        bufs["init_normal"].normal_(generator=self.generator)

    def gumbel(self, shape: Sequence[int],
               device: torch.device) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=self.generator, device=device)
        return gumbel_from_uniform(
            u.clamp_min_(torch.finfo(u.dtype).tiny))


class ReplayDraws:
    """Draws made elsewhere, replayed in order.

    For the sync round: ``gumbel`` [T, K], ``uniform`` [T, E, k, batch]
    and ``normal`` [T, E], indexed by the round t.  For the async engine:
    ``gumbel`` [T, E, K], ``uniform`` [T, E, k, batch], ``normal`` [T, E],
    indexed by the event t, and ``init_gumbel`` [E, K], ``init_normal``
    [E].  Items past T read zeros (the loop masks them).  For the serving
    engine: ``gumbel`` [n_steps, B, V], one per sampling step, in order.
    """

    def __init__(self, gumbel=None, uniform=None, normal=None, *,
                 init_gumbel=None, init_normal=None):
        self.arrays = {name: None if a is None else torch.from_numpy(
            np.array(a, np.float32))
            for name, a in zip(ROUND_DRAWS + INIT_DRAWS,
                               (gumbel, uniform, normal, init_gumbel,
                                init_normal))}
        self._step = 0

    def fill(self, bufs: Dict[str, torch.Tensor], t0: int) -> None:
        for name in ROUND_DRAWS:
            src, buf = self.arrays[name], bufs[name]
            if src is None:
                raise ValueError(f"ReplayDraws holds no {name!r} draws")
            if src.shape[1:] != buf.shape[1:]:
                raise ValueError(f"ReplayDraws {name!r} rounds are "
                                 f"{tuple(src.shape[1:])}, the loop reads "
                                 f"{tuple(buf.shape[1:])}")
            chunk = torch.zeros(buf.shape, dtype=torch.float32)
            part = src[t0:t0 + buf.shape[0]]
            chunk[:part.shape[0]] = part
            buf.copy_(chunk)

    def fill_init(self, bufs: Dict[str, torch.Tensor]) -> None:
        for name in INIT_DRAWS:
            src, buf = self.arrays[name], bufs[name]
            if src is None:
                raise ValueError(f"ReplayDraws holds no {name!r} draws")
            if src.shape != buf.shape:
                raise ValueError(f"ReplayDraws {name!r} is "
                                 f"{tuple(src.shape)}, the loop reads "
                                 f"{tuple(buf.shape)}")
            buf.copy_(src)

    def gumbel(self, shape: Sequence[int],
               device: Optional[torch.device] = None) -> torch.Tensor:
        src = self.arrays["gumbel"]
        if src is None or self._step >= src.shape[0]:
            raise ValueError("ReplayDraws ran out of Gumbel draws")
        g = src[self._step]
        if tuple(g.shape) != tuple(shape):
            raise ValueError(f"ReplayDraws Gumbel draw {self._step} is "
                             f"{tuple(g.shape)}, the caller wants "
                             f"{tuple(shape)}")
        self._step += 1
        return g.to(device)

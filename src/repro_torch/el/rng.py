"""The RNG seam: every random draw of the port's device loops.

The reference's compiled programs draw from ``jax.random`` keys, which
torch cannot reproduce.  So the device loops take their randomness from a
provider, never from a generator of their own:

  * the compiled sync round (``repro_torch.el.ingraph``) asks, per round
    t, for the Gumbel vector ``[K]`` of its arm selection, the minibatch
    uniforms ``[E, k, batch]`` of its local blocks and the cost-noise
    normals ``[E]``; a chunk of R rounds at once, written into static
    buffers (``fill``) that a captured CUDA graph reads;
  * the serving engine asks for one Gumbel array per sampling step
    (``gumbel``).

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

#: The round-draw buffers a chunk of R rounds reads, by name:
#: ``gumbel`` [R, K], ``uniform`` [R, E, k, batch], ``normal`` [R, E].
ROUND_DRAWS = ("gumbel", "uniform", "normal")


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """``-log(-log(u))`` in place, u uniform in [tiny, 1) (the reference's
    ``jax.random.gumbel``, which draws u from [tiny, 1))."""
    return u.log_().neg_().log_().neg_()


class TorchDraws:
    """Draws from ``generator`` (on the device the buffers live on)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def fill(self, bufs: Dict[str, torch.Tensor], t0: int) -> None:
        """Write rounds ``t0 .. t0 + R - 1``'s draws into ``bufs``."""
        g = self.generator
        tiny = float(torch.finfo(torch.float32).tiny)
        gumbel_from_uniform(bufs["gumbel"].uniform_(tiny, 1.0, generator=g))
        bufs["uniform"].uniform_(generator=g)
        bufs["normal"].normal_(generator=g)

    def gumbel(self, shape: Sequence[int],
               device: torch.device) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=self.generator, device=device)
        return gumbel_from_uniform(
            u.clamp_min_(torch.finfo(u.dtype).tiny))


class ReplayDraws:
    """Draws made elsewhere, replayed in order.

    For the sync round: ``gumbel`` [T, K], ``uniform`` [T, E, k, batch]
    and ``normal`` [T, E], indexed by the round t (rounds past T read
    zeros; the loop masks them).  For the serving engine: ``gumbel``
    [n_steps, B, V], one per sampling step, taken in order.
    """

    def __init__(self, gumbel=None, uniform=None, normal=None):
        self.arrays = {name: None if a is None else torch.from_numpy(
            np.array(a, np.float32))
            for name, a in zip(ROUND_DRAWS, (gumbel, uniform, normal))}
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

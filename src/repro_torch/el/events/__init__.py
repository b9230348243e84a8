"""``repro_torch.el.events`` — the compiled asynchronous EL engine.

The paper's async event loop as a device program with no host priority
queue: edge finish times live in an ``[E]`` tensor, each step pops the
earliest (or, with ``batch_k > 1``, a wave of the earliest) completion,
staleness-merges the edge's block, updates its bandit and budget and
schedules its next block, in chunks of masked steps replayed as CUDA
graphs on a card.

  * :func:`make_async_program` — ``program(init_params, knobs, draws)``,
    an :class:`AsyncProgram`; :func:`make_async_cell` its pieces;
  * :func:`async_knobs` / :data:`ASYNC_KNOB_NAMES` — the control-plane
    inputs; :func:`default_event_horizon`, :func:`padded_event_horizon`,
    :func:`bucket_event_horizon` and :func:`resolve_async_batch_k`;
  * :func:`schedule_block`, :func:`wave_safe_gap`,
    :func:`staleness_alpha`, :func:`staleness_merge` — the shared
    scheduling arithmetic; :func:`bandit_fleet_init` /
    :func:`bandit_slice` / :func:`bandit_place` — the per-edge bandits;
  * :func:`run_async_reference` — the host event-queue twin on the
    program's draws (``ELSession.run_async(rng_streams="jax")``), bit
    for bit the program's at fixed cost.

Front door: ``ELSession.run_async_ingraph()``.
"""

from repro_torch.el.events.knobs import (ASYNC_KNOB_NAMES, async_knob_names,
                                         async_knobs, bucket_event_horizon,
                                         default_event_horizon,
                                         padded_event_horizon,
                                         resolve_async_batch_k)
from repro_torch.el.events.program import (AsyncProgram, make_async_cell,
                                           make_async_kernels,
                                           make_async_program)
from repro_torch.el.events.reference import run_async_reference
from repro_torch.el.events.scheduler import (schedule_block, staleness_alpha,
                                             staleness_merge, wave_safe_gap)
from repro_torch.el.events.state import (bandit_fleet_init, bandit_place,
                                         bandit_slice)

__all__ = [
    "ASYNC_KNOB_NAMES", "async_knob_names", "async_knobs",
    "bucket_event_horizon", "default_event_horizon", "padded_event_horizon",
    "resolve_async_batch_k", "AsyncProgram", "make_async_cell",
    "make_async_kernels", "make_async_program", "run_async_reference",
    "schedule_block", "staleness_alpha", "staleness_merge", "wave_safe_gap",
    "bandit_fleet_init", "bandit_place", "bandit_slice",
]

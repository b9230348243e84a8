"""``repro_torch.el.sweep`` — ablation sweeps as one device loop.

Turns a declarative :class:`SweepSpec` (grids over ``ucb_c``, budgets,
heterogeneity, cost noise, async mixing rate, wave width, seeds) into one
run of the compiled sync round (``repro_torch.el.ingraph``) or async
event engine (``repro_torch.el.events``) — picked by the session's
``cfg.mode`` — with a leading ``[n_cells]`` dimension: the masked step
vmapped (``torch.func.vmap``) over the cells, one CUDA graph replay a chunk on
a card.  Each cell makes the decisions of an independent
``ELSession.run_sync_ingraph`` / ``run_async_ingraph`` with that cell's
config on the same draws.  Front door: ``ELSession.sweep(spec)`` →
:class:`SweepReport`.  :class:`CellBatch` steps the same vmapped cells a
wave at a time over slots (the fleet's engine).
"""

from repro_torch.el.sweep.engine import (CellBatch, cell_draws, knob_names,
                                         make_cell_batch, make_sweep_program,
                                         run_sweep_program, stack_knobs)
from repro_torch.el.sweep.report import SweepReport
from repro_torch.el.sweep.spec import (AXIS_ORDER, SweepSpec,
                                       spec_from_sequences)

__all__ = [
    "SweepSpec", "SweepReport", "AXIS_ORDER", "spec_from_sequences",
    "make_sweep_program", "run_sweep_program", "stack_knobs", "cell_draws",
    "knob_names", "CellBatch", "make_cell_batch",
]

"""repro_torch.el.scenarios — fleet dynamics for the port's device loops.

The port of the reference's ``repro.el.scenarios``.  Churn (join/leave/
dropout/reconnect activity masks), heavy-tailed and trace-replayed
per-edge cost models (straggler spikes), non-stationary data drift, and
task-allocation baseline policies — all injected *inside* the compiled
sync round and async engine as schedule knobs, so every scenario axis is
sweepable and "OL4EL vs baselines under churn" is one device loop.
``scenario=None`` keeps every program the scenario-less one, op for op.

Layout:

- ``spec``      — frozen+hashable ``ScenarioSpec``/``ChurnSpec``/``CostSpec``
- ``schedule``  — host-side knob materialization (``scenario_knobs``)
- ``baselines`` — the device policy switch + the task-allocation baselines
- ``reference`` — host-side replay oracles for churn schedules
- ``cli``       — shared ``--churn/--cost-model/--drift`` argparse glue
"""

from repro_torch.el.scenarios.spec import (ChurnSpec, CostSpec, ScenarioSpec,
                                           as_scenario)
from repro_torch.el.scenarios.schedule import (SCENARIO_KNOB_NAMES,
                                               activity_schedule,
                                               cost_schedule,
                                               scenario_knob_names,
                                               scenario_knobs)
from repro_torch.el.scenarios.baselines import (INGRAPH_POLICY_ORDER,
                                                ingraph_policy_id,
                                                select_arm_switch)
from repro_torch.el.scenarios.reference import (replay_sync_scenario,
                                                verify_sync_replay)

__all__ = [
    "ChurnSpec", "CostSpec", "ScenarioSpec", "as_scenario",
    "SCENARIO_KNOB_NAMES", "activity_schedule", "cost_schedule",
    "scenario_knob_names", "scenario_knobs",
    "INGRAPH_POLICY_ORDER", "ingraph_policy_id", "select_arm_switch",
    "replay_sync_scenario", "verify_sync_replay",
]

from repro_torch.federated.aggregation import (staleness_alpha,
                                               staleness_mix,
                                               weighted_average)
from repro_torch.federated.executors import ClassicExecutor, LMExecutor
from repro_torch.federated.simulator import ELSimulator, SimResult

__all__ = ["weighted_average", "staleness_mix", "staleness_alpha",
           "ClassicExecutor", "LMExecutor", "ELSimulator", "SimResult"]

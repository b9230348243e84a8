from repro_torch.data.classic_data import (make_traffic_dataset,
                                           make_wafer_dataset,
                                           partition_edges)
from repro_torch.data.pipeline import SyntheticLMData, lm_batch

__all__ = ["make_wafer_dataset", "make_traffic_dataset", "partition_edges",
           "SyntheticLMData", "lm_batch"]

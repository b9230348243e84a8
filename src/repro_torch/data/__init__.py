from repro_torch.data.classic_data import (make_traffic_dataset,
                                           make_wafer_dataset,
                                           partition_edges)

__all__ = ["make_wafer_dataset", "make_traffic_dataset", "partition_edges"]

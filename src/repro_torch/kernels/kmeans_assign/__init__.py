from repro_torch.kernels.kmeans_assign import ops, ref
from repro_torch.kernels.kmeans_assign.ops import (assign, assign_with_dist,
                                                   assign_with_dist_batched)

__all__ = ["assign", "assign_with_dist", "assign_with_dist_batched", "ops",
           "ref"]

from repro_torch.kernels.kmeans_assign import ops, ref
from repro_torch.kernels.kmeans_assign.ops import assign, assign_with_dist

__all__ = ["assign", "assign_with_dist", "ops", "ref"]

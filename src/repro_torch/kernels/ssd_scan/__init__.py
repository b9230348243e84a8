from repro_torch.kernels.ssd_scan import ops, ref
from repro_torch.kernels.ssd_scan.ops import ssd

__all__ = ["ssd", "ops", "ref"]

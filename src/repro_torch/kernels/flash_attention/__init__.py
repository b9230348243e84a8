from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.kernels.flash_attention.ops import flash_attention

__all__ = ["flash_attention", "ops", "ref"]

"""ctypes binding of the Hopper flash-attention kernel.

The kernel itself is CUDA C++ in ``repro_torch/csrc/flash_attention.cu``
(see its header for the design and what bounds it), in two instances that
its entry point picks by dtype: bf16 on the tensor cores (``mma.sync``),
f32 on the CUDA cores, each built for the head dims ``HEAD_DIMS``.  This
module builds it on first use, declares its C signature, checks a shape's
shared-memory budget and launches it.  Another head dim up to the largest
instance runs on that instance's tiles: ``pad_head_dim`` zero-pads q, k
and v along D (zero columns add exact zeros to every q.k, and give zero
output columns), the launch keeps the caller's scale 1/sqrt(D), and
``unpad`` slices the output back.  Shape and dtype checks live in the
``ops`` wrapper.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

SOURCES = ("flash_attention.cu",)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)     # the head dims the .cu is instantiated for


def library_path():
    """Build if needed; the shared library's path (its ``.log`` beside)."""
    return _build.library_path("flash_attention", SOURCES)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = _build.load("flash_attention", SOURCES)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci,
                                           ci, ci, ci, ctypes.c_float, ci,
                                           vp]
    lib.flash_attention_launch.restype = ci
    lib.flash_attention_max_smem.argtypes = [ci, ctypes.POINTER(ci)]
    lib.flash_attention_max_smem.restype = ci
    lib.flash_attention_error_string.argtypes = [ci]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention {what} failed: CUDA error "
                           f"{err} ({msg})")


def padded_head_dim(d: int) -> int:
    """The head dim the kernel runs a caller's ``d`` at: the smallest
    instance in ``HEAD_DIMS`` that holds it.  Raises past the largest."""
    for dp in HEAD_DIMS:
        if d <= dp:
            return dp
    raise ValueError(f"flash_attention: head dim {d} exceeds the kernel's "
                     f"largest instance, {HEAD_DIMS[-1]}")


def pad_head_dim(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k and v zero-padded along D to ``padded_head_dim(D)``: new
    contiguous tensors (16-byte aligned, as a fresh allocation is), or
    the inputs themselves where D is an instance's."""
    d = q.shape[-1]
    extra = padded_head_dim(d) - d
    if not extra:
        return q, k, v
    return tuple(F.pad(t, (0, extra)) for t in (q, k, v))


def unpad(out: torch.Tensor, d: int) -> torch.Tensor:
    """The first ``d`` columns of a padded output, contiguous (``out``
    itself where it has ``d``)."""
    return out if out.shape[-1] == d else out[..., :d].contiguous()


def tiles(d: int, dtype: torch.dtype) -> tuple:
    """(query rows per block, keys per tile) of ``dtype``'s instance at
    head dim ``d``, as the .cu's tiles: bf16 (64, 64); f32 (128, 64) up to
    D = 128, (64, 64) above (``f32::Tile``)."""
    if dtype == torch.bfloat16:
        return 64, 64
    return (128, 64) if d <= 128 else (64, 64)


def smem_bytes(d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block, as the .cu lays it out for
    ``dtype``'s instance: the query tile, and key and value tiles, rows
    padded to D+8 bf16 with two stages of each (tensor cores) or to D+4
    f32 with one of each (CUDA cores)."""
    bq, bk = tiles(d, dtype)
    if dtype == torch.bfloat16:
        return 2 * (d + 8) * (bq + 2 * 2 * bk)
    return 4 * (d + 4) * (bq + 2 * bk)


@functools.lru_cache(maxsize=None)
def max_smem(device_index: int) -> int:
    lib = library()
    limit = ctypes.c_int(0)
    _check(lib, lib.flash_attention_max_smem(device_index,
                                             ctypes.byref(limit)),
           "shared-memory query")
    return limit.value


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, window: int, out: torch.Tensor,
              scale: float) -> None:
    """Launch on the current stream: q [B,S,H,D], k and v [B,S,KV,D]
    (contiguous, one CUDA device, one dtype, f32 or bf16) into out
    [B,S,H,D], the logits scaled by ``scale`` (1/sqrt of the caller's head
    dim, which a padded call does not change).  Raises when the head
    dim's block does not fit the card's shared memory or the kernel has
    no instance for it."""
    bsz, s, h, d = q.shape
    need, limit = smem_bytes(d, q.dtype), max_smem(q.device.index)
    if need > limit:
        raise ValueError(
            f"flash_attention: head dim {d} at {q.dtype} needs {need} bytes "
            f"of shared memory per block; the card allows {limit}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} is not one of the "
                         f"kernel's {HEAD_DIMS}")
    if any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("flash_attention: the kernel copies q, k and v and "
                         "stores o in 16-byte pieces; they must start "
                         "16-byte aligned")
    lib = library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bsz, s, h,
        k.shape[2], d, int(causal), int(window), scale,
        _DTYPE_CODE[q.dtype], stream)
    _check(lib, err, "launch")

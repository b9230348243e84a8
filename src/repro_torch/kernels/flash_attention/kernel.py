"""ctypes binding of the Hopper flash-attention kernel.

The kernel itself is CUDA C++ in ``repro_torch/csrc/flash_attention.cu``
(see its header for the design and what bounds it), in two instances that
its entry point picks by dtype: bf16 on the tensor cores (``mma.sync``),
f32 on the CUDA cores.  This module builds it on first use, declares its
C signature, checks a shape's shared-memory budget and launches it.
Shape and dtype checks live in the ``ops`` wrapper.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

SOURCES = ("flash_attention.cu",)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# per instance, as the .cu's kBlockQ / kBlockK: query rows per block, key
# rows per tile
BLOCK_Q = {torch.float32: 64, torch.bfloat16: 64}
BLOCK_K = {torch.float32: 32, torch.bfloat16: 64}
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


def smem_bytes(d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block, as the .cu lays it out for
    ``dtype``'s instance.  f32 (CUDA cores), all f32: the query tile
    [BLOCK_Q, D+1], a key tile [BLOCK_K, D+1], a value tile [BLOCK_K, D]
    and the probabilities [BLOCK_Q, BLOCK_K+1].  bf16 (tensor cores), all
    bf16 with rows padded to D+8: the query tile and two stages of key and
    value tiles [BLOCK_K, D+8]."""
    bq, bk = BLOCK_Q[dtype], BLOCK_K[dtype]
    if dtype == torch.bfloat16:
        return 2 * (d + 8) * (bq + 2 * 2 * bk)
    return 4 * (bq * (d + 1) + bk * (d + 1) + bk * d + bq * (bk + 1))


@functools.lru_cache(maxsize=None)
def max_smem(device_index: int) -> int:
    lib = library()
    limit = ctypes.c_int(0)
    _check(lib, lib.flash_attention_max_smem(device_index,
                                             ctypes.byref(limit)),
           "shared-memory query")
    return limit.value


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, window: int, out: torch.Tensor) -> None:
    """Launch on the current stream: q [B,S,H,D], k and v [B,S,KV,D]
    (contiguous, one CUDA device, one dtype, f32 or bf16) into out
    [B,S,H,D].  Raises when the head dim's block does not fit the card's
    shared memory or the kernel has no instance for it."""
    bsz, s, h, d = q.shape
    need, limit = smem_bytes(d, q.dtype), max_smem(q.device.index)
    if need > limit:
        raise ValueError(
            f"flash_attention: head dim {d} at {q.dtype} needs {need} bytes "
            f"of shared memory per block; the card allows {limit}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} is not one of the "
                         f"kernel's {HEAD_DIMS}")
    lib = library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bsz, s, h,
        k.shape[2], d, int(causal), int(window), 1.0 / math.sqrt(d),
        _DTYPE_CODE[q.dtype], stream)
    _check(lib, err, "launch")

"""ctypes binding of the Hopper SSD scan kernel.

The kernel itself is CUDA C++ in ``repro_torch/csrc/ssd_scan.cu`` (see its
header for the design and what bounds it); this module builds it on first
use, declares its C signature, checks a shape's shared-memory budget and
launches it.  Shape and dtype checks live in the ``ops`` wrapper.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

SOURCES = ("ssd_scan.cu",)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ROWS = 32                      # chunk rows per block of G (the .cu's kRows)
MAX_CHUNK = 128


def library_path():
    """Build if needed; the shared library's path (its ``.log`` beside)."""
    return _build.library_path("ssd_scan", SOURCES)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = _build.load("ssd_scan", SOURCES)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                                    ci, vp, vp, vp]
    lib.ssd_scan_launch.restype = ci
    lib.ssd_scan_max_smem.argtypes = [ci, ctypes.POINTER(ci)]
    lib.ssd_scan_max_smem.restype = ci
    lib.ssd_scan_error_string.argtypes = [ci]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.ssd_scan_error_string(err).decode()
        raise RuntimeError(f"ssd_scan {what} failed: CUDA error {err} "
                           f"({msg})")


def smem_bytes(p: int, n: int, chunk: int) -> int:
    """Dynamic shared memory of one block, as the .cu lays it out: the
    state [P, N+1], x [L, P], B [L, N+1], a row block of C [ROWS, N] and
    of G [ROWS, L], and three [L] vectors, all f32."""
    return 4 * (p * (n + 1) + chunk * p + chunk * (n + 1) + ROWS * n
                + ROWS * chunk + 3 * chunk)


@functools.lru_cache(maxsize=None)
def max_smem(device_index: int) -> int:
    lib = library()
    limit = ctypes.c_int(0)
    _check(lib, lib.ssd_scan_max_smem(device_index, ctypes.byref(limit)),
           "shared-memory query")
    return limit.value


def ssd_fwd(x: torch.Tensor, da: torch.Tensor, b_mat: torch.Tensor,
            c_mat: torch.Tensor, chunk: int, y: torch.Tensor,
            final_state: torch.Tensor) -> None:
    """Launch on the current stream: x [B,S,H,P], da [B,S,H] f32, b/c
    [B,S,N] (contiguous, one CUDA device, x's dtype f32 or bf16) into
    y [B,S,H,P] (x's dtype) and final_state [B,H,P,N] f32.  Raises when
    the shape's block does not fit the card's shared memory."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    need, limit = smem_bytes(p, n, chunk), max_smem(x.device.index)
    if need > limit:
        raise ValueError(
            f"ssd_scan: P={p}, N={n}, chunk={chunk} needs {need} bytes of "
            f"shared memory per block; the card allows {limit}")
    lib = library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ssd_scan_launch(
        x.data_ptr(), da.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
        bsz, s, h, p, n, chunk, _DTYPE_CODE[x.dtype], y.data_ptr(),
        final_state.data_ptr(), stream)
    _check(lib, err, "launch")

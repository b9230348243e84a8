"""ctypes binding of the Hopper SSD scan kernel.

The kernel itself is CUDA C++ in ``repro_torch/csrc/ssd_scan.cu`` (see its
header for the design and what bounds it), in two instances that its
entry point picks by dtype: bf16 on the tensor cores (``mma.sync``), f32
on the CUDA cores.  This module builds it on first use, declares its
C signature, plans a shape (``plan``: the widths a bf16 call is padded
to, the chunk length it runs at, the bf16 instance's P tile, the f32
instance's heads per diagonal block, both instances' shared-memory
budget) and launches it.  Shape and dtype checks live in the ``ops``
wrapper, which pads a call around the launch (``pad_widths``,
``unpad``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

SOURCES = ("ssd_scan.cu",)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
F32_P_TILE = 64                # f32: P columns of a carry block (kPTile)
MAX_N = 256                    # N at most: the f32 carry block's state
                               # columns (bf16 refuses past it too)
F32_MAX_GROUP = 16             # f32: heads a diagonal block takes at most
MAX_CHUNK = 128                # the chunk length a block runs at, at most
P_TILES = (16, 32, 64, 128)    # bf16: the P tiles the .cu is built for
ITEM_COLS = 32                 # bf16: state columns per item (kItemCols)
MAX_ITEMS = 4                  # bf16: state items a warp may hold (kMaxItems)
WARPS = 8                      # bf16: warps per scan block (kWarps)


def library_path():
    """Build if needed; the shared library's path (its ``.log`` beside)."""
    return _build.library_path("ssd_scan", SOURCES)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    return declare(_build.load("ssd_scan", SOURCES))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures on a loaded build of ``ssd_scan.cu``."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                                    ci, ci, ci, vp, vp, vp]
    lib.ssd_scan_launch.restype = ci
    lib.ssd_scan_bf16_smem.argtypes = [ci, ci, ci]
    lib.ssd_scan_bf16_smem.restype = ci
    lib.ssd_scan_f32_smem.argtypes = [ci, ci, ci]
    lib.ssd_scan_f32_smem.restype = ci
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


def padded_chunk(chunk: int) -> int:
    """Both instances' rows per chunk tile: L rounded up to 16."""
    return -(-chunk // 16) * 16


def f32_diag_smem(n: int, chunk: int) -> int:
    """Dynamic shared memory of the f32 diagonal block (``f32::diag_smem``),
    all f32, Lp = L rounded up to 16 and N4 = N rounded up to 4: G [Lp,
    Lp+4]; then C and B [Lp, N4+4] while G is formed, in the same bytes
    later Gd [Lp, Lp+4] and two x slabs [Lp, 64]; and da, then a_cs, of
    up to F32_MAX_GROUP heads [F32_MAX_GROUP, Lp]."""
    lp, n4 = padded_chunk(chunk), -(-n // 4) * 4
    return 4 * (lp * (lp + 4) + max(2 * lp * (n4 + 4),
                                    lp * (lp + 4) + 2 * lp * 64)
                + F32_MAX_GROUP * lp)


def f32_carry_smem(n: int, chunk: int) -> int:
    """Dynamic shared memory of the f32 carry block (``f32::carry_smem``),
    all f32, N padded to 64, 128 or 256 (Np): C and B [Lp, Np+4], x's tile
    [Lp, F32_P_TILE], the state [F32_P_TILE, Np+4] and four [Lp] vectors."""
    lp = padded_chunk(chunk)
    ns = 64 * (1 if n <= 64 else 2 if n <= 128 else 4) + 4
    return 4 * (2 * lp * ns + lp * F32_P_TILE + F32_P_TILE * ns + 4 * lp)


def smem_bytes(p: int, n: int, chunk: int, dtype: torch.dtype,
               p_tile: int = None) -> int:
    """Dynamic shared memory of one block, as the .cu lays it out for
    ``dtype``'s instance.  f32 (CUDA cores): the larger of its two
    kernels' blocks, ``f32_diag_smem`` and ``f32_carry_smem``.  bf16
    (tensor cores), for a block owning ``p_tile`` (default P) columns of P,
    with Lp = L rounded up to 16: two stages of x [Lp, Pt+8], B and C [Lp,
    N+8] in bf16 and da [Lp] in f32, the state's hi and lo bf16 parts [Pt,
    N+8], and four [Lp] vectors and 8 totals in f32."""
    if dtype == torch.bfloat16:
        pt = p if p_tile is None else p_tile
        lp = padded_chunk(chunk)
        stage = 2 * lp * (pt + 8) + 2 * 2 * lp * (n + 8) + 4 * lp
        return 2 * stage + 2 * 2 * pt * (n + 8) + 4 * (4 * lp + 8)
    return max(f32_diag_smem(n, chunk), f32_carry_smem(n, chunk))


def f32_heads_per_block(bsz: int, s: int, h: int, p: int, n: int,
                        chunk: int, sms: int) -> int:
    """f32: the heads one diagonal block takes.  A block forms its chunk's
    G = C B^T once (work ~ N) and then each head's Gd x (~ P); at one
    block an SM, the plan takes the head count (up to F32_MAX_GROUP) with
    the fewest waves x (N + heads P), the smaller count on a tie."""
    rows = bsz * (s // chunk)
    best, best_cost = 1, None
    for hg in range(1, min(h, F32_MAX_GROUP) + 1):
        waves = -(-rows * -(-h // hg) // sms)
        cost = waves * (n + hg * p)
        if best_cost is None or cost < best_cost:
            best, best_cost = hg, cost
    return best


def state_items(p_tile: int, n: int) -> int:
    """bf16: the state items (16 rows of P, ``ITEM_COLS`` columns of N)
    each warp of a scan block holds in registers for the whole sequence:
    the warps sharing a P tile split its column groups.  The .cu takes
    this count from the launch and picks its instance by it."""
    groups = -(-n // ITEM_COLS)
    return -(-groups // (WARPS // (p_tile // 16)))


def padded_widths(p: int, n: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(P, N) the kernel runs a call at: bf16 rounds both up to a multiple
    of 16 (``mma.sync`` tiles; the wrapper pads with zeros, which is
    exact: zero columns of B and C add zeros to G and to the state, zero
    columns of x give zero columns of y, and every column of P is
    independent of the others); f32 takes them as they are.  Raises past
    ``MAX_N`` state columns, in both dtypes."""
    if n > MAX_N:
        raise ValueError(f"ssd_scan: N={n} exceeds the {MAX_N} state "
                         f"columns a block of the kernel holds")
    if dtype == torch.bfloat16:
        return -(-p // 16) * 16, -(-n // 16) * 16
    return p, n


def pad_widths(x: torch.Tensor, b_mat: torch.Tensor, c_mat: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x's P and b's and c's N zero-padded to ``padded_widths``: new
    contiguous tensors where a width grows, else the inputs themselves."""
    p, n = x.shape[-1], b_mat.shape[-1]
    pp, np_ = padded_widths(p, n, x.dtype)
    if pp != p:
        x = F.pad(x, (0, pp - p))
    if np_ != n:
        b_mat, c_mat = F.pad(b_mat, (0, np_ - n)), F.pad(c_mat, (0, np_ - n))
    return x, b_mat, c_mat


def unpad(y: torch.Tensor, final_state: torch.Tensor, p: int, n: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y [.., P] and the final state [.., P, N] sliced back to a caller's
    P and N, contiguous (the tensors themselves where nothing was
    padded)."""
    if final_state.shape[-2:] == (p, n):
        return y, final_state
    return y[..., :p].contiguous(), final_state[..., :p, :n].contiguous()


def sub_chunks(chunk: int) -> list:
    """The chunk lengths the kernel may run a caller's ``chunk`` at,
    largest first: its divisors up to ``MAX_CHUNK``.  Chunking only
    blocks the recurrence (the state is carried from chunk to chunk), so
    every one computes the same function, up to rounding."""
    return [c for c in range(min(chunk, MAX_CHUNK), 0, -1) if chunk % c == 0]


def bf16_tiles(bsz: int, h: int, p: int, n: int, sms: int) -> list:
    """bf16: the P tiles to try, in order.  P / 2 first where twice B * H
    blocks still run in one wave (one block per SM), else P first.  (At
    B * H = 128 on an H100's 132 SMs, P / 2 makes two waves and ran 1.7x
    slower than P; at B * H = 32 it ran 1.09x faster:
    ``scripts/ssd_scan_variants.py``, PERF.md.)  A tile must be built
    (``P_TILES``), divide P and leave a warp at most ``MAX_ITEMS`` items of
    the state; where neither P nor P / 2 does, the largest tile that does
    (P = 48 takes 16)."""
    def ok(t):
        return t in P_TILES and p % t == 0 and state_items(t, n) <= MAX_ITEMS
    order = (p // 2, p) if 2 * bsz * h <= sms else (p, p // 2)
    return [t for t in order if ok(t)] or [max(filter(ok, P_TILES))]


class Plan(NamedTuple):
    """How the kernel runs one call (``plan``)."""
    p: int          # P it runs at (bf16: rounded up to 16)
    n: int          # N likewise
    chunk: int      # the chunk length it runs at, dividing the caller's
    p_tile: int     # the P columns one scan (bf16) or carry (f32) block owns
    items: int      # bf16: state items a warp holds; f32: heads a diagonal
                    # block takes


def plan(bsz: int, s: int, h: int, p: int, n: int, chunk: int,
         dtype: torch.dtype, limit: int, sms: int) -> Plan:
    """The kernel's plan for a call on a card with ``sms`` SMs and
    ``limit`` bytes of opt-in shared memory a block: the widths
    (``padded_widths``), then the largest chunk length in
    ``sub_chunks(chunk)`` whose block fits, and its P tile.

    f32: the carry block's F32_P_TILE columns (all of P when P is
    smaller) and the heads a diagonal block takes
    (``f32_heads_per_block``).  bf16: the first of ``bf16_tiles`` that
    fits, and its state items.  Every shape whose caller's chunk fits
    runs at that chunk, unpadded where P and N are multiples of 16.
    Raises ``ValueError`` naming the limit past ``MAX_N`` state columns."""
    p, n = padded_widths(p, n, dtype)
    bf16 = dtype == torch.bfloat16
    tiles = bf16_tiles(bsz, h, p, n, sms) if bf16 else [min(p, F32_P_TILE)]
    for length in sub_chunks(chunk):
        for t in tiles:
            if smem_bytes(p, n, length, dtype, t) <= limit:
                items = (state_items(t, n) if bf16 else f32_heads_per_block(
                    bsz, s, h, p, n, length, sms))
                return Plan(p, n, length, t, items)
    raise ValueError(
        f"ssd_scan: P={p}, N={n} at {dtype} needs "
        f"{smem_bytes(p, n, 1, dtype, tiles[-1])} bytes of shared memory "
        f"per block at the shortest chunk; the card allows {limit}")


@functools.lru_cache(maxsize=None)
def max_smem(device_index: int) -> int:
    lib = library()
    limit = ctypes.c_int(0)
    _check(lib, lib.ssd_scan_max_smem(device_index, ctypes.byref(limit)),
           "shared-memory query")
    return limit.value


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def ssd_fwd(x: torch.Tensor, da: torch.Tensor, b_mat: torch.Tensor,
            c_mat: torch.Tensor, chunk: int, y: torch.Tensor,
            final_state: torch.Tensor) -> None:
    """Launch on the current stream: x [B,S,H,P], da [B,S,H] f32, b/c
    [B,S,N] (contiguous, one CUDA device, x's dtype f32 or bf16; bf16 P
    and N multiples of 16, as ``padded_widths`` leaves them) into y
    [B,S,H,P] (x's dtype) and final_state [B,H,P,N] f32, at the chunk
    length ``plan`` picks from ``chunk``.  Raises (``plan``) for a shape
    the kernel cannot take."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    dev = x.device.index
    run = plan(bsz, s, h, p, n, chunk, x.dtype, max_smem(dev), sm_count(dev))
    if (run.p, run.n) != (p, n):
        raise ValueError(f"ssd_scan: the {x.dtype} instance takes P and N "
                         f"in multiples of 16, got P={p}, N={n}")
    if x.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 for t in (x, b_mat, c_mat)):
        raise ValueError("ssd_scan: the bf16 instance copies x, b and c in "
                         "16-byte pieces; they must start 16-byte aligned")
    lib = library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ssd_scan_launch(
        x.data_ptr(), da.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
        bsz, s, h, p, n, run.chunk, _DTYPE_CODE[x.dtype], run.p_tile,
        run.items, y.data_ptr(), final_state.data_ptr(), stream)
    _check(lib, err, "launch")

"""Fused activation prologue on Hopper, its plain version, its launch plan
and its launch counters.

The kernel (``csrc/fused_prologue.cu``, CUDA C++ for sm_90a) replaces the
TPU kernel ``repro/kernels/prologue.py::fused_prologue_kernel``: it
quantizes the rows of x (M, K) to xq int8 and sx (M, 1) f32 (with
``group`` g, dividing K, the (M, K/g) scale plane of its ``act_group``
branch), and projects ``xv = x·V`` (M, R) f32; with ``rotate`` it does both
on ``x·H_K`` (K a power of two, with V or without).  It is the first kernel
of the chained path (``kernels/ops.py``), whose GEMM is ``kernels/w4a4.py``.

The codes and scales are bitwise those of ``rowops.scale_round_quantize``
(the quantizer is ``csrc/quant_rows.cuh``, shared with ``act_quant``).  x·V
has one order at every launch geometry and M: per K-chunk of
``rowops.project_rows_tiled``'s default size, eight fmaf chains over its
eighths added in order, the chunk sums in ascending K; only that order
differs from the plain version's.

Bound on an H100 SXM (3.35 TB/s, 67 f32 TFLOP/s): at decode, memory, V
dominating (2·K·R bytes in bf16, 5 MB and 1.5 us at K=8192, R=307); at
large M the f32 operations 2·M·K·R.  Two regimes from shapes alone
(:func:`prologue_plan`; the source's head comment says what each does):
M <= 16 (and larger M where the tiles below would not fill the card)
streams V by cp.async with K split in chunks over blocks; larger M takes
register-tiled 128 x 64 output tiles, K split only where the tiles leave
the card under-filled.  With ``rotate`` a first launch rotates each
row once.  An unrotated call is one device operation: no memset, scratch
cached per stream, tickets left at zero by every launch.

:func:`fused_prologue` is the wrapper: a CPU tensor runs
:func:`fused_prologue_plain`; a CUDA tensor launches the kernel or raises.
``LAUNCHES`` counts each call once (a rotated call with V is two device
launches).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.hadamard import MAX_D, check_width
from repro_torch.kernels.rowops import (check_group, default_proj_tiles, fwht_rows,
                                        project_rows, scale_round_quantize)

KERNEL = "fused_prologue"
LAUNCHES = {"fused_prologue": 0, "fused_prologue_plain": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def fused_prologue_plain(x, v=None, bits: int = 4, clip_ratio: float = 1.0,
                         rotate: bool = False, group: int = None):
    """The kernel's function in plain torch, in ``rowops``' operation order.

    x (M, K) float; v (K, R) or None; ``rotate`` quantizes and projects the
    f32 rows of ``x·H_K`` (K a power of two); ``group`` (dividing K)
    quantizes them per group.  Returns (xq (M, K) int8, sx (M, 1) f32 or
    the (M, K // group) plane, xv (M, R) f32 or None)."""
    if rotate:
        check_width(x.shape[1])
    if group is not None:
        check_group(x.shape[1], group)
    LAUNCHES["fused_prologue_plain"] += 1
    xf = x.to(torch.float32)
    if rotate:
        xf = fwht_rows(xf, xf.shape[1])
    xq, sx = scale_round_quantize(xf, 2 ** (bits - 1) - 1, clip_ratio, group)
    return xq, sx, None if v is None else project_rows(xf, v)


# the source's plan constants: sub-chunk chains a chunk; the stream
# regime's M and least tiled K; the stream block's threads and columns; the
# tiled block's output tile, k a stage, stages and threads; tiled blocks an
# SM the K-split aims at
SUBS = 8
STREAM_M, TILED_MIN_K = 16, 256
S_THREADS, S_COLS = 256, 32
T_BM, T_BN, T_BK, T_STAGES, T_THREADS = 128, 64, 32, 3, 128
WAVES = 2
# SMs of an H100 SXM; the kernel reads the card's own count
H100_SMS = 132


def _seg_bytes(n: int, es: int) -> int:
    """Shared bytes of a copied row segment of n elements of es bytes."""
    return 16 * ((n * es + 15) // 16 + 1)


class ProloguePlan(NamedTuple):
    """A call of the kernel at (M, K, R), as the source plans it
    (``fused_prologue_plan``; the fields in its order)."""

    tiled: int            # 1: register tiles; 0: the V stream
    rows: int             # rows of an output tile
    cols: int             # columns of an output tile
    tiles_m: int
    tiles_r: int
    bk: int               # K chunk
    chunks: int
    chunks_per_split: int
    splits: int           # blocks over K a tile (stream: one a chunk)
    threads: int          # of the projection launch
    smem_bytes: int
    launches: int         # device launches: 2 with rotate and V
    zeroed_bytes: int     # tickets: zero between launches
    scratch_bytes: int    # chunk partials where K is split, then rotated rows


def prologue_plan(m: int, k: int, r: int, rotate: bool = False, x_bytes: int = 2,
                  v_bytes: int = 2, sms: int = H100_SMS) -> ProloguePlan:
    """The kernel's launch plan, from (M, K, R), the rotation, the operand
    widths (bytes of an x and of a V value) and the SM count alone.

    Stream (M <= 16, K < 256, or fewer (128 x 64 output tile, chunk) pairs
    than SMs): a block per (chunk, 32 columns, row tile of 4 rows at M <=
    4 (16 columns where 32-column blocks would be fewer than the SMs), 8
    at M <= 16; else 16 rows by 64 columns).  Tiled: 128 x 64 output
    tiles, over all
    of K, or, where the tiles are fewer than the SMs, over whole chunks so
    that about ``WAVES`` blocks run an SM.  Where K is split, ``zeroed``
    holds a ticket per output tile and ``scratch`` the chunk partials
    [tiles][chunks][rows][cols] f32; with rotate and V, then the rotated
    rows (M, K) f32, which the projection reads (its x 4 bytes)."""
    if rotate:
        x_bytes = 4
    bk = default_proj_tiles(k, 1)[0]  # the reference's x·V chunk, the source's chunk_k
    chunks = -(-k // bk)
    tiled = int(m > STREAM_M and k >= TILED_MIN_K
                and -(-m // T_BM) * -(-r // T_BN) * chunks >= sms)
    if tiled:
        rows, cols, threads = T_BM, T_BN, T_THREADS
        smem = (T_STAGES * (T_BM * _seg_bytes(T_BK, x_bytes) + T_BK * _seg_bytes(T_BN, v_bytes))
                + 4 * T_BK * (T_BM + T_BN))
    else:
        rows = 4 if m <= 4 else 8 if m <= STREAM_M else STREAM_M
        lc16 = rows == 4 and chunks * -(-r // S_COLS) * -(-m // 4) < sms
        cols = (S_COLS // 2 if lc16 else S_COLS) * (2 if rows == STREAM_M else 1)
        threads = S_THREADS
        smem = (max(bk * _seg_bytes(cols, v_bytes), 4 * SUBS * rows * cols)
                + SUBS * rows * _seg_bytes(bk // SUBS, x_bytes))
    tiles_m, tiles_r = -(-m // rows), -(-r // cols)
    if r == 0:  # quantizer blocks alone: their reduction's shared memory
        smem = 4 * (S_THREADS // 32)
    ntiles = tiles_m * tiles_r
    cps, splits = 1, chunks
    if tiled:
        cps = -(-chunks // -(-(WAVES * sms) // max(ntiles, 1))) if ntiles < sms else chunks
        splits = -(-chunks // cps)
    split = r > 0 and splits > 1
    part = 4 * ntiles * chunks * rows * cols if split else 0
    return ProloguePlan(tiled, rows, cols, tiles_m, tiles_r, bk, chunks, cps, splits, threads,
                        smem, 2 if rotate and r > 0 else 1, 4 * ntiles if split else 0,
                        part + (4 * m * k if rotate and r > 0 else 0))


@functools.lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    """The built library with its C signatures declared (once per name)."""
    lib = build.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_prologue.argtypes = [p, i, p, i, p, p, p, p, p, i, i, i, i, i,
                                   ctypes.c_float, i, p]
    lib.fused_prologue.restype = ctypes.c_int
    lib.fused_prologue_plan.argtypes = [i, i, i, i, i, i, i, ctypes.POINTER(ctypes.c_longlong)]
    lib.fused_prologue_plan.restype = None
    lib.fused_prologue_max_rotate_k.argtypes = []
    lib.fused_prologue_max_rotate_k.restype = i
    return lib


@functools.lru_cache(maxsize=1024)
def source_plan(m: int, k: int, r: int, rotate: bool = False, x_bytes: int = 2,
                v_bytes: int = 2, sms: int = 0) -> ProloguePlan:
    """The built kernel's own plan (``sms`` 0: the SM count of the card the
    process first launched on, which the source reads once);
    :func:`prologue_plan` mirrors it."""
    out = (ctypes.c_longlong * len(ProloguePlan._fields))()
    _lib(KERNEL).fused_prologue_plan(m, k, r, int(rotate), int(x_bytes == 2),
                                     int(v_bytes == 2), sms, out)
    return ProloguePlan(*out)


# per (device index, stream): [zeroed, scratch] byte buffers, grown on
# demand.  Every launch leaves ``zeroed`` all zero (each tile's last block
# resets its ticket), so one buffer serves every shape; launches on one
# stream never overlap.
_SCRATCH = {}


def _scratch(device, stream: int, zeroed: int, scratch: int):
    bufs = _SCRATCH.setdefault((device.index, stream), [None, None])
    if zeroed and (bufs[0] is None or bufs[0].numel() < zeroed):
        bufs[0] = torch.zeros(zeroed, dtype=torch.uint8, device=device)
    if scratch and (bufs[1] is None or bufs[1].numel() < scratch):
        bufs[1] = torch.empty(scratch, dtype=torch.uint8, device=device)
    return (bufs[0].data_ptr() if zeroed else None,
            bufs[1].data_ptr() if scratch else None)


def fused_prologue(x, v=None, bits: int = 4, clip_ratio: float = 1.0,
                   rotate: bool = False, group: int = None):
    """One call of the prologue kernel; returns (xq, sx, xv-or-None).

    Arguments as :func:`fused_prologue_plain`.  A CPU ``x`` runs the plain
    version; a CUDA ``x`` launches the kernel on the current stream, or
    raises if it cannot."""
    if x.device.type == "cpu":
        return fused_prologue_plain(x, v, bits, clip_ratio, rotate, group)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    build.check_activations(x, bits)
    m, k = x.shape
    if rotate:
        check_width(k)
        if k > MAX_D:
            raise ValueError(f"rotated K={k} exceeds the kernel's {MAX_D}")
    if group is not None:
        check_group(k, group)
    r = 0
    tensors = [x]
    if v is not None:
        r = v.shape[-1]
        if v.dim() != 2 or v.shape[0] != k:
            raise ValueError(f"v must be ({k}, R); got {tuple(v.shape)}")
        if v.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"v must be float32 or bfloat16, got {v.dtype}")
        tensors.append(v)
    build.check_operands(x, tensors)
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((m, 1 if group is None else k // group), dtype=torch.float32,
                     device=x.device)
    xv = None if v is None else torch.empty((m, r), dtype=torch.float32,
                                            device=x.device)
    if m == 0:
        return xq, sx, xv
    lib = _lib(KERNEL)
    plan = source_plan(m, k, r, bool(rotate), x.element_size(),
                       2 if v is None else v.element_size())
    stream = build.stream_of(x)
    zeroed, scratch = _scratch(x.device, stream, plan.zeroed_bytes, plan.scratch_bytes)
    rc = lib.fused_prologue(
        x.data_ptr(), int(x.dtype == torch.bfloat16),
        None if v is None else v.data_ptr(),
        int(v is not None and v.dtype == torch.bfloat16), xq.data_ptr(),
        sx.data_ptr(), None if xv is None else xv.data_ptr(), zeroed, scratch, m, k, r,
        group or 0, 2 ** (bits - 1) - 1, float(clip_ratio), int(rotate), stream)
    if rc != 0:
        raise RuntimeError(f"fused_prologue launch failed: cudaError {rc} "
                           f"at (M={m}, K={k}, R={r}, group={group})")
    LAUNCHES["fused_prologue"] += 1
    return xq, sx, xv

"""W4A4 GEMM with the low-rank epilogue on Hopper, its plain version, its
launch plan and its launch counters.

The kernel (``csrc/w4a4_lowrank_matmul.cu``, CUDA C++ for sm_90a) replaces
the TPU kernel ``repro/kernels/w4a4.py::w4a4_lowrank_matmul_kernel``:

    out = (xq · unpack(Wp)) · sx · sw  +  xv · Uᵀ        (M, N) f32

from precomputed xq/sx (``fused_prologue`` or ``act_quant``) and xv; with
``group`` g, sx is the (M, K/g) scale plane and the GEMM dequantizes in the
K loop in ``rowops.gemm_grouped``'s canonical order, bitwise at any launch
geometry.  It is the GEMM of the chained and unfused paths
(``kernels/ops.py``).

Bound on an H100 SXM (3.35 TB/s, 1,979 int8 TOPS, 67 f32 TFLOP/s): at
decode the call is memory-bound; its bytes are K·N/2 (packed W) + 4·N (sw)
+ 2·R·N (bf16 U) plus the activations, e.g. 12.6 MB (3.8 us) at Phi-3-mini's
K=8192, N=3072, R=307.  At M 2048 its int8 operations and the LR term's
f32 ones bound it.  The integer product runs on the int8 tensor cores
(``mma.sync`` m16n8k32) from packed W tiles staged by ``cp.async``; M <= 16
streams W with K split across blocks and the LR term in blocks of its own,
larger M takes 128 x 128 tiles (:func:`gemm_plan`; the source's head
comment says what it does and what later work should change).

:func:`w4a4_lowrank_matmul` is the wrapper: a CPU tensor runs
:func:`w4a4_lowrank_matmul_plain`; a CUDA tensor launches the kernel or
raises.  ``LAUNCHES`` counts each.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rowops import check_group, gemm_lowrank, unpack_int4_rows

KERNEL = "w4a4_lowrank_matmul"
LAUNCHES = {"w4a4_lowrank_matmul": 0, "w4a4_lowrank_matmul_plain": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


# the source's plan constants: K codes a stage (decode, large tile), columns
# a tile, the largest M of the weight stream, decode LR blocks a tile,
# decode GEMM blocks an SM
DECODE_BK, LARGE_BK, BN, DECODE_M, LR_BLOCKS, WAVES = 64, 128, 128, 16, 4, 3


def _seg_bytes(n: int, es: int) -> int:
    """Shared bytes of a copied row segment of n elements of es bytes."""
    return 16 * ((n * es + 15) // 16 + 1)


# (threads, dynamic shared bytes) of a block: decode (16 x 128 tile, 3
# stages; the LR blocks' copies of 32 U rows and 16 xv rows, 640 bytes of U
# a row), large (128 x 128, 4 stages; after them, in the same memory, the
# copies of 128 U and xv rows of 32 ranks and their f32 transposes)
DECODE_BLOCK = (128, max(3 * (DECODE_BK // 2 * BN + 16 * DECODE_BK),
                         32 * _seg_bytes(640, 1) + 16 * _seg_bytes(320, 4)))
LARGE_BLOCK = (256, max(4 * (LARGE_BK // 2 * BN + 128 * LARGE_BK),
                        (BN + 128) * _seg_bytes(32, 4) + 32 * (BN + 128) * 4))
# SMs of an H100 SXM; the kernel reads the card's own count
H100_SMS = 132


class GemmPlan(NamedTuple):
    """A launch of the kernel at (M, K, N, group), as the source plans it
    (``w4a4_lowrank_matmul_plan``; the fields in its order)."""

    decode: int           # 1: M <= 16, the weight stream; 0: 128 x 128 tiles
    bm: int               # rows of a tile
    tiles_n: int
    tiles_m: int
    stages: int           # K stages of DECODE_BK or LARGE_BK codes
    stages_per_split: int
    splits: int           # K-splits (decode only; 1 for large M)
    threads: int
    smem_bytes: int
    zeroed_bytes: int     # tickets (+ the group plane): zero between launches
    scratch_bytes: int    # per-token split partials (+ the LR terms)
    lr_blocks_per_tile: int


def gemm_plan(m: int, k: int, n: int, group: int = None, sms: int = H100_SMS) -> GemmPlan:
    """The kernel's launch plan, from (M, K, N, group) and the SM count
    alone: M <= 16 streams W over about ``WAVES`` GEMM blocks an SM, K split
    in whole stages, with ``LR_BLOCKS`` LR blocks per 128-column tile; larger
    M takes 128 x 128 tiles over all of K.  Scratch at decode: ``zeroed``
    holds a ticket per 32-column sub-tile and, group-wise where K is split,
    the int32 group plane [tiles][K/g][M][BN], which the splits add into and
    each sub-tile's last block reads and zeroes; ``scratch`` the per-token
    int32 partials [tiles][splits][M][BN] where K is split, then the LR
    terms [M][tiles · BN] f32."""
    decode = int(m <= DECODE_M)
    bm = 16 if decode else 128
    tiles_n, tiles_m = -(-n // BN), -(-m // bm)
    stages = -(-k // (DECODE_BK if decode else LARGE_BK))
    per = stages
    if decode:
        want = -(-(WAVES * sms) // tiles_n)
        per = -(-stages // want)
    per = max(per, 1)
    splits = -(-stages // per)
    threads, smem = DECODE_BLOCK if decode else LARGE_BLOCK
    zeroed = scratch = 0
    if decode:
        plane = tiles_n * (k // group) * m * BN if group and splits > 1 else 0
        part = tiles_n * splits * m * BN if not group and splits > 1 else 0
        zeroed = 4 * (tiles_n * LR_BLOCKS + plane)
        scratch = 4 * (part + m * tiles_n * BN)
    return GemmPlan(decode, bm, tiles_n, tiles_m, stages, per, splits, threads, smem,
                    zeroed, scratch, LR_BLOCKS)


def w4a4_lowrank_matmul_plain(xq, sx, wpacked, sw, xv=None, u=None,
                              group: int = None) -> torch.Tensor:
    """The kernel's function in plain torch, in ``rowops``' operation order
    (``ref.w4a4_lowrank_matmul_ref``'s math).

    xq (M, K) int8; sx (M, 1) f32, or with ``group`` (dividing K) the (M,
    K // group) plane; wpacked (K/2, N) uint8; sw (N,) or (1, N) f32; xv
    (M, R) f32 or None; u (N, R) or None.  Returns (M, N) f32."""
    LAUNCHES["w4a4_lowrank_matmul_plain"] += 1
    return gemm_lowrank(xq, unpack_int4_rows(wpacked), sx, sw, xv, u, group)


@functools.lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    """The built library with its C signature declared (once per name)."""
    lib = build.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.w4a4_lowrank_matmul.argtypes = [p, p, p, p, p, p, i, p, p, p, i, i, i, i, i, p]
    lib.w4a4_lowrank_matmul.restype = ctypes.c_int
    lib.w4a4_lowrank_matmul_plan.argtypes = [i, i, i, i, i, ctypes.POINTER(ctypes.c_longlong)]
    lib.w4a4_lowrank_matmul_plan.restype = None
    return lib


@functools.lru_cache(maxsize=1024)
def source_plan(m: int, k: int, n: int, group: int = None, sms: int = 0) -> GemmPlan:
    """The built kernel's own plan (``sms`` 0: the SM count of the card the
    process first launched on, which the source reads once);
    :func:`gemm_plan` mirrors it."""
    out = (ctypes.c_longlong * len(GemmPlan._fields))()
    _lib(KERNEL).w4a4_lowrank_matmul_plan(m, k, n, group or 0, sms, out)
    return GemmPlan(*out)


# per (device index, stream): [zeroed, scratch] byte buffers, grown on
# demand.  Every launch leaves ``zeroed`` all zero (the tile's last block
# resets its ticket and the plane entries it read), so one buffer serves
# every shape; launches on one stream never overlap.
_SCRATCH = {}


def _scratch(device, stream: int, zeroed: int, scratch: int):
    bufs = _SCRATCH.setdefault((device.index, stream), [None, None])
    if zeroed and (bufs[0] is None or bufs[0].numel() < zeroed):
        bufs[0] = torch.zeros(zeroed, dtype=torch.uint8, device=device)
    if scratch and (bufs[1] is None or bufs[1].numel() < scratch):
        bufs[1] = torch.empty(scratch, dtype=torch.uint8, device=device)
    return (bufs[0].data_ptr() if zeroed else None,
            bufs[1].data_ptr() if scratch else None)


def _check(xq, sx, wpacked, sw, xv, u, group=None):
    if xq.dim() != 2 or xq.dtype != torch.int8:
        raise TypeError(f"xq must be (M, K) int8; got {xq.dtype} {tuple(xq.shape)}")
    m, k = xq.shape
    if wpacked.dtype != torch.uint8 or wpacked.dim() != 2 or wpacked.shape[0] * 2 != k:
        raise ValueError(f"wpacked must be uint8 ({k // 2}, N); got "
                         f"{wpacked.dtype} {tuple(wpacked.shape)}")
    n = wpacked.shape[1]
    if group is not None:
        check_group(k, group)
    want = (m, 1) if group is None else (m, k // group)
    if sx.dtype != torch.float32 or (sx.numel() != m if group is None
                                     else tuple(sx.shape) != want):
        raise ValueError(f"sx must be float32 {want} (M={m}, K={k}, group={group}); "
                         f"got {sx.dtype} {tuple(sx.shape)}")
    if sw.dtype != torch.float32 or sw.numel() != n:
        raise ValueError(f"sw must be float32 with {n} entries; got "
                         f"{sw.dtype} {tuple(sw.shape)}")
    if (xv is None) != (u is None):
        raise ValueError("xv and u must both be given or both be None")
    tensors = [xq, sx, wpacked, sw]
    if xv is not None:
        r = xv.shape[-1]
        if tuple(xv.shape) != (m, r) or tuple(u.shape) != (n, r):
            raise ValueError(f"xv must be ({m}, R) and u ({n}, R); got "
                             f"{tuple(xv.shape)}, {tuple(u.shape)}")
        if xv.dtype != torch.float32 or u.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"xv must be float32 and u float32 or bfloat16; "
                            f"got {xv.dtype}, {u.dtype}")
        tensors += [xv, u]
    build.check_operands(xq, tensors)


def w4a4_lowrank_matmul(xq, sx, wpacked, sw, xv=None, u=None,
                        group: int = None) -> torch.Tensor:
    """One launch of the W4A4 low-rank GEMM kernel; returns (M, N) f32.

    Arguments as :func:`w4a4_lowrank_matmul_plain`.  A CPU ``xq`` runs the
    plain version; a CUDA ``xq`` launches the kernel on the current stream,
    or raises if it cannot."""
    if xq.device.type == "cpu":
        return w4a4_lowrank_matmul_plain(xq, sx, wpacked, sw, xv, u, group)
    if xq.device.type != "cuda":
        raise ValueError(f"unsupported device {xq.device}")
    build.refuse_grad("w4a4_lowrank_matmul", sx, sw, xv, u)
    _check(xq, sx, wpacked, sw, xv, u, group)
    m, k = xq.shape
    n = wpacked.shape[1]
    r = 0 if xv is None else xv.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    if m == 0 or n == 0:
        return out
    lib = _lib(KERNEL)
    plan = source_plan(m, k, n, group)
    stream = build.stream_of(xq)
    zeroed, scratch = _scratch(xq.device, stream, plan.zeroed_bytes, plan.scratch_bytes)
    rc = lib.w4a4_lowrank_matmul(
        xq.data_ptr(), sx.data_ptr(), wpacked.data_ptr(), sw.data_ptr(),
        None if xv is None else xv.data_ptr(),
        None if u is None else u.data_ptr(),
        int(u is not None and u.dtype == torch.bfloat16), out.data_ptr(),
        zeroed, scratch, m, k, n, r, group or 0, stream)
    if rc != 0:
        raise RuntimeError(f"w4a4_lowrank_matmul launch failed: cudaError {rc} "
                           f"at (M={m}, K={k}, N={n}, R={r}, group={group})")
    LAUNCHES["w4a4_lowrank_matmul"] += 1
    return out

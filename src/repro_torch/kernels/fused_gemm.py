"""Single-kernel fused W4A4+LRC forward on Hopper, its plain version, its
launch plan and its launch counters.

The kernel (``csrc/fused_w4a4_lrc.cu``, CUDA C++ for sm_90a) replaces the
TPU kernel ``repro/kernels/fused_gemm.py::fused_w4a4_lrc_kernel``: one
launch quantizes the rows of x, projects ``xv = x·V``, runs the int4 GEMM
and writes the f32 epilogue ``acc·sx·sw + xv·Uᵀ``; xq never reaches device
memory.  With ``group`` g (its ``act_group`` branch) the rows are quantized
per group of g and the GEMM sums the groups in ``rowops.gemm_grouped``'s
canonical order; with ``rotate`` the quantizer and x·V take ``x·H_K`` (K a
power of two, the rows rotated by ``csrc/fwht_rows.cuh``).  Every output is
bitwise the chained path's (``prologue.fused_prologue`` then
``w4a4.w4a4_lowrank_matmul``) on the same inputs, at any M: the same
quantizer, #3's one x·V order, exact int32 sums and #2's epilogue order.

Bound on an H100 SXM (3.35 TB/s): at decode the call is memory-bound.  Its
bytes are K·N/2 (packed W) + 4·N (sw) + 2·R·(K+N) (bf16 V, U) plus the
activations (x in, f32 out); for the widest SmolLM-135M site (K=576,
N=1536, R=58) that is about 0.7 MB, 0.2 us.  The design (the source's head
comment; :func:`fused_plan` mirrors its plan): a thread-block cluster of up
to 8 blocks shares one 16-row tile's prologue, each block taking a K slice
of the quantizer and of the x·V chains and its own 32 output columns; the
blocks exchange partial amax, x·V chain sums and codes through distributed
shared memory, then each runs the GEMM of its columns over all of K on the
int8 tensor cores (``mma.sync`` m16n8k32, the B fragments expanded from
packed W as in #2).

:func:`fused_w4a4_lrc` is the wrapper: a CPU tensor runs
:func:`fused_w4a4_lrc_plain`; a CUDA tensor launches the kernel or raises.
``LAUNCHES`` counts each: the wrapper adds one where it launches the kernel,
the plain version one per call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.hadamard import check_width
from repro_torch.kernels.rowops import (check_group, default_proj_tiles, fwht_rows,
                                        gemm_lowrank, project_rows, scale_round_quantize,
                                        unpack_int4_rows)

KERNEL = "fused_w4a4_lrc"
LAUNCHES = {"fused_w4a4_lrc": 0, "fused_w4a4_lrc_plain": 0}
# dynamic shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232448
MAX_RANK = 1024
# the source's plan constants: rows of a tile, output columns of a block,
# threads of a block, K of one mma, bytes of a factor row an x·V and LR tile
# takes (64 bf16 ranks, 32 f32), blocks of a cluster at most, blocks an SM
# at most (its launch bounds), an SM's shared memory and the part of it
# reserved for each block
ROWS, BN, THREADS, KSTEP, RT_BYTES, MAX_CLUSTER = 16, 32, 256, 32, 128, 8
# M up to DECODE_M takes row tiles of SMALL_TILE rows, larger M tiles of ROWS
DECODE_M, SMALL_TILE = 16, 4
MAX_BLOCKS_SM, SM_SMEM, BLOCK_RESERVED = 2, 233472, 1024
# SMs of an H100 SXM; the kernel reads the card's own count
H100_SMS = 132


def admission_bytes(k: int, r: int, act_group: int = None) -> int:
    """The admission rule's bytes at (K, R, ``act_group``): the shared
    memory of the first fused kernel's one-block design (rows, x·V, U
    tile, scale plane, a 32 KB V buffer, codes and unpacked W, whose
    footprint grew with K), kept as the rule that decides which sites
    "auto" sends to the fused path, so the served routes do not move with
    the kernel's design.  The kernel's
    own footprint is :func:`smem_bytes`, within ``SMEM_LIMIT`` wherever
    this rule admits a site (``tests/test_torch_fused_plan.py``)."""
    k16 = (k + 15) & ~15
    scales = 1 if act_group is None else k // act_group
    return (4 * (ROWS * k + ROWS * r + BN * r + ROWS * scales)
            + 8 * 16 * THREADS + ROWS * k16 + k16 * BN)


def fits(k: int, r: int, act_group: int = None) -> bool:
    """Whether "auto" takes the fused path at (K, R, act_group): the
    admission rule's bytes within the limit and the rank within
    MAX_RANK."""
    return admission_bytes(k, r, act_group) <= SMEM_LIMIT and r <= MAX_RANK


def _split(k: int):
    """The source's split_of: x·V chunk and sub-chunk, the K unit (whole
    sub-chunks and mma k-steps), K a block, blocks a cluster."""
    bk = default_proj_tiles(k, 1)[0]  # the reference's x·V chunk, the source's xv_chunk
    sub = bk // 8
    unit = max(KSTEP, sub)
    units = -(-k // unit)
    upb = -(-units // MAX_CLUSTER)
    return bk, sub, unit, upb * unit, -(-units // upb)


def _a16(x: int) -> int:
    return (x + 15) & ~15


def _seg_bytes(n: int, es: int) -> int:
    """Shared bytes of a copied row segment of n elements of es bytes."""
    return 16 * ((n * es + 15) // 16 + 1)


def smem_bytes(k: int, r: int, act_group: int = None, rotate: bool = False,
               x_bytes: int = 2, f_bytes: int = 2) -> int:
    """Dynamic shared memory one block of the kernel needs at (K, R,
    ``act_group``), rotated or not, with x and the U/V factors of
    ``x_bytes`` / ``f_bytes`` bytes: the source's
    ``fused_w4a4_lrc_smem_bytes``, computed here from shapes alone
    (``chip_smoke.py`` holds the two equal).  The rows staged in f32 (whole
    rows when rotated), the slice's V rows of a rank tile, the chain sums of
    the (row, rank) pairs the block folds, packed W, U rows and sw of its 32
    columns, the amax and scales; then, over the raw x rows, the cluster's
    codes, an x·V tile and the GEMM's partials.  A rank tile is 128 bytes of
    a factor row: 64 bf16 ranks, 32 f32."""
    _, sub, _, ks, cluster = _split(k)
    xlen, lr, rt = (k if rotate else ks), r > 0, RT_BYTES // f_bytes
    share = -(-(ROWS * rt) // cluster)
    early = (_a16(4 * ROWS * xlen) + (ks * _seg_bytes(rt, f_bytes) if lr else 0)
             + (_a16(4 * (cluster * ks // sub) * share) if lr else 0) + -(-k // KSTEP) * 16 * BN
             + (BN * _seg_bytes(rt, f_bytes) if lr else 0) + _seg_bytes(BN, 4)
             + _a16(4 * ROWS * (k // act_group if act_group else 1)))
    late = (ROWS * (cluster * ks + 16) + (4 * ROWS * rt if lr else 0)
            + 4 * ROWS * BN * (1 if act_group else 4))
    # f32 rows of whole 16-byte words are copied straight into the staged rows
    raw = 0 if x_bytes == 4 and k % 4 == 0 else ROWS * _seg_bytes(xlen, x_bytes)
    return early + max(late, raw)


class FusedPlan(NamedTuple):
    """A launch of the kernel, as the source plans it
    (``fused_w4a4_lrc_plan``; the fields in its order)."""

    tiles_m: int          # row tiles
    tile_m: int           # rows a tile: 4 where M <= 16, else 16
    col_blocks: int       # 32-column blocks that own outputs
    cluster: int          # blocks a cluster (<= 8): the K split of the prologue
    clusters_n: int       # column clusters a row tile (C·32 columns each)
    bk: int               # x·V chunk
    sub: int              # x·V sub-chunk (one fmaf chain)
    unit: int             # K unit of the split: whole sub-chunks and k-steps
    k_per_block: int      # K slice of a block
    r_tiles: int          # rank tiles of x·V and the LR term (64 bf16 ranks, 32 f32)
    threads: int
    smem_bytes: int
    blocks: int           # grid blocks (past N: blocks that share the prologue only)
    blocks_per_sm: int
    waves: int


def fused_plan(m: int, k: int, n: int, r: int, group: int = None, rotate: bool = False,
               x_bytes: int = 2, f_bytes: int = 2, sms: int = H100_SMS) -> FusedPlan:
    """The kernel's launch plan from shapes, the operand widths and the SM
    count alone: a cluster of ``cluster`` blocks per (row tile, C·32
    columns; 4 rows a tile where M <= 16, else 16), block b of it owning K slice b (``k_per_block`` values) of
    the prologue and its own 32 columns of the GEMM over all of K."""
    bk, sub, unit, ks, cluster = _split(k)
    tile_m = SMALL_TILE if m <= DECODE_M else ROWS
    tiles_m, col_blocks = -(-m // tile_m), -(-n // BN)
    clusters_n = -(-col_blocks // cluster)
    smem = smem_bytes(k, r, group, rotate, x_bytes, f_bytes)
    blocks = tiles_m * clusters_n * cluster
    per_sm = min(MAX_BLOCKS_SM, SM_SMEM // (smem + BLOCK_RESERVED))
    waves = -(-blocks // (sms * per_sm)) if per_sm else 0
    return FusedPlan(tiles_m, tile_m, col_blocks, cluster, clusters_n, bk, sub, unit, ks,
                     -(-r // (RT_BYTES // f_bytes)), THREADS, smem, blocks, per_sm, waves)


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def fused_w4a4_lrc_plain(x, v, wpacked, sw, u, bits: int = 4,
                         clip_ratio: float = 1.0, rotate: bool = False,
                         group: int = None) -> torch.Tensor:
    """The kernel's function in plain torch, in ``rowops``' operation order.

    x (M, K) float; v (K, R) or None; wpacked (K/2, N) uint8; sw (N,) or
    (1, N) f32; u (N, R) or None; ``rotate`` quantizes and projects the f32
    rows of ``x·H_K`` (K a power of two); ``group`` (dividing K) quantizes
    them per group.  Returns (M, N) f32."""
    if rotate:
        check_width(x.shape[1])
    LAUNCHES["fused_w4a4_lrc_plain"] += 1
    qmax = 2 ** (bits - 1) - 1
    xf = x.to(torch.float32)
    if rotate:
        xf = fwht_rows(xf, xf.shape[1])
    xq, sx = scale_round_quantize(xf, qmax, clip_ratio, group)
    xv = None if v is None else project_rows(xf, v)
    return gemm_lowrank(xq, unpack_int4_rows(wpacked), sx, sw, xv, u, group)


@functools.lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    """The built library with its C signatures declared (once per name)."""
    lib = build.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_w4a4_lrc.argtypes = [p, i, p, p, p, p, i, p, i, i, i, i, i, i,
                                   ctypes.c_float, i, p]
    lib.fused_w4a4_lrc.restype = ctypes.c_int
    lib.fused_w4a4_lrc_smem_bytes.argtypes = [i, i, i, i, i, i]
    lib.fused_w4a4_lrc_smem_bytes.restype = ctypes.c_size_t
    lib.fused_w4a4_lrc_plan.argtypes = [i, i, i, i, i, i, i, i, i,
                                        ctypes.POINTER(ctypes.c_longlong)]
    lib.fused_w4a4_lrc_plan.restype = None
    return lib


@functools.lru_cache(maxsize=1024)
def source_plan(m: int, k: int, n: int, r: int, group: int = None, rotate: bool = False,
                x_bytes: int = 2, f_bytes: int = 2, sms: int = 0) -> FusedPlan:
    """The built kernel's own plan (``sms`` 0: the SM count of the card the
    process first launched on, which the source reads once);
    :func:`fused_plan` mirrors it."""
    out = (ctypes.c_longlong * len(FusedPlan._fields))()
    _lib(KERNEL).fused_w4a4_lrc_plan(m, k, n, r, group or 0, int(rotate), int(x_bytes == 2),
                                     int(f_bytes == 2), sms, out)
    return FusedPlan(*out)


def _check(x, v, wpacked, sw, u, bits):
    build.check_activations(x, bits)
    if wpacked.dim() != 2:
        raise ValueError(f"wpacked must be (K/2, N); got {tuple(wpacked.shape)}")
    m, k = x.shape
    n = wpacked.shape[1]
    if wpacked.dtype != torch.uint8 or wpacked.shape[0] * 2 != k:
        raise ValueError(f"wpacked must be uint8 ({k // 2}, N); got "
                         f"{wpacked.dtype} {tuple(wpacked.shape)}")
    if sw.dtype != torch.float32 or sw.numel() != n:
        raise ValueError(f"sw must be float32 with {n} entries; got "
                         f"{sw.dtype} {tuple(sw.shape)}")
    if (u is None) != (v is None):
        raise ValueError("u and v must both be given or both be None")
    tensors = [x, wpacked, sw]
    if v is not None:
        r = v.shape[-1]
        if tuple(v.shape) != (k, r) or tuple(u.shape) != (n, r):
            raise ValueError(f"v must be ({k}, R) and u ({n}, R); got "
                             f"{tuple(v.shape)}, {tuple(u.shape)}")
        if v.dtype != u.dtype or v.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"u and v must share a float32 or bfloat16 dtype; "
                            f"got {u.dtype}, {v.dtype}")
        if r > MAX_RANK:
            raise ValueError(f"v must have rank <= {MAX_RANK}; got R={r}")
        tensors += [u, v]
    build.check_operands(x, tensors)


def fused_w4a4_lrc(x, v, wpacked, sw, u, bits: int = 4,
                   clip_ratio: float = 1.0, rotate: bool = False,
                   group: int = None) -> torch.Tensor:
    """One launch of the fused W4A4+LRC kernel; returns (M, N) f32.

    Arguments as :func:`fused_w4a4_lrc_plain`.  A CPU ``x`` runs the plain
    version; a CUDA ``x`` launches the kernel on the current stream, or
    raises if it cannot."""
    if x.device.type == "cpu":
        return fused_w4a4_lrc_plain(x, v, wpacked, sw, u, bits, clip_ratio, rotate,
                                    group)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    build.refuse_grad("fused_w4a4_lrc", x, v, sw, u)
    _check(x, v, wpacked, sw, u, bits)
    m, k = x.shape
    if rotate:
        check_width(k)
    if group is not None:
        check_group(k, group)
    n = wpacked.shape[1]
    r = 0 if v is None else v.shape[1]
    need = smem_bytes(k, r, group, rotate, x.element_size(),
                      2 if v is None else v.element_size())
    if need > SMEM_LIMIT:
        raise ValueError(f"(K={k}, R={r}, group={group}) needs {need} bytes of "
                         f"shared memory per block; the limit is {SMEM_LIMIT}")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    if x.dtype == torch.float32 and k % 4 == 0 and x.data_ptr() % 16:
        x = x.clone()  # the kernel copies such rows in whole 16-byte words
    rc = _lib(KERNEL).fused_w4a4_lrc(
        x.data_ptr(), int(x.dtype == torch.bfloat16),
        None if v is None else v.data_ptr(), wpacked.data_ptr(),
        sw.data_ptr(), None if u is None else u.data_ptr(),
        int(v is not None and v.dtype == torch.bfloat16), out.data_ptr(),
        m, k, n, r, group or 0, 2 ** (bits - 1) - 1, float(clip_ratio), int(rotate),
        build.stream_of(x))
    if rc != 0:
        what = {-1: "its block's shared memory exceeds the limit",
                -2: "no cluster of its plan fits on the card"}.get(rc, f"cudaError {rc}")
        raise RuntimeError(f"fused_w4a4_lrc launch failed: {what} "
                           f"at (M={m}, K={k}, N={n}, R={r}, group={group})")
    LAUNCHES["fused_w4a4_lrc"] += 1
    return out

"""Single-kernel fused W4A4+LRC forward on Hopper, its plain version and
its launch counters.

The kernel (``csrc/fused_w4a4_lrc.cu``, CUDA C++ for sm_90a) replaces the
TPU kernel ``repro/kernels/fused_gemm.py::fused_w4a4_lrc_kernel``: one
launch quantizes the rows of x into shared memory (xq never reaches device
memory), projects ``xv = x·V``, runs the int4 GEMM with ``__dp4a`` and
writes the f32 epilogue ``acc·sx·sw + xv·Uᵀ``.  With ``group`` g (its
``act_group`` branch) the rows are quantized per group of g into a
ROWS × K/g scale plane in shared memory, and the GEMM sums the groups in
``rowops.gemm_grouped``'s canonical order.
With ``rotate`` the quantizer and x·V take ``x·H_K`` (K a power of two):
the block rotates its staged f32 rows in place (``csrc/fwht_rows.cuh``,
bitwise ``rowops.fwht_rows``), so its shared memory, and :func:`fits`, do
not change.

Bound on an H100 SXM (3.35 TB/s): at decode the call is memory-bound.  Its
bytes are K·N/2 (packed W) + 4·N (sw) + 2·R·(K+N) (bf16 V, U) plus the
activations (x in, f32 out); for the widest SmolLM-135M site (K=576,
N=1536, R=58) that is about 0.7 MB, 0.2 us.  The first design reads W once
per M-tile and keeps xq on chip, but recomputes the prologue (amax,
quantize, x·V) in every N-tile and uses no tensor cores: the source's head
comment lists what it does and what later work should change.

:func:`fused_w4a4_lrc` is the wrapper: a CPU tensor runs
:func:`fused_w4a4_lrc_plain`; a CUDA tensor launches the kernel or raises.
``LAUNCHES`` counts each: the wrapper adds one where it launches the kernel,
the plain version one per call.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.hadamard import check_width
from repro_torch.kernels.rowops import (check_group, fwht_rows, gemm_lowrank,
                                        project_rows, scale_round_quantize,
                                        unpack_int4_rows)

KERNEL = "fused_w4a4_lrc"
LAUNCHES = {"fused_w4a4_lrc": 0, "fused_w4a4_lrc_plain": 0}
# dynamic shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232448
MAX_RANK = 1024
# tile constants of csrc/fused_w4a4_lrc.cu, for smem_bytes
_MAX_ROWS, _BN, _VBYTES = 16, 32, 8 * 16 * 256


def smem_bytes(k: int, r: int, act_group: int = None) -> int:
    """Dynamic shared memory one block of the kernel needs at (K, R) and
    ``act_group`` (None: per-token), with the larger row tile: the source's
    ``fused_w4a4_lrc_smem_bytes``, computed here from shapes alone so a
    plan can be chosen before anything is built or launched
    (``chip_smoke.py`` holds the two equal).  Group-wise the rows' scales
    are a ROWS × K/g plane."""
    k16 = (k + 15) & ~15
    scales = 1 if act_group is None else k // act_group
    return (4 * (_MAX_ROWS * k + _MAX_ROWS * r + _BN * r + _MAX_ROWS * scales)
            + _VBYTES + _MAX_ROWS * k16 + k16 * _BN)


def fits(k: int, r: int, act_group: int = None) -> bool:
    """Whether the kernel takes (K, R, act_group): its shared memory
    within the limit and the rank within MAX_RANK."""
    return smem_bytes(k, r, act_group) <= SMEM_LIMIT and r <= MAX_RANK


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
    lib.fused_w4a4_lrc_smem_bytes.argtypes = [i, i, i]
    lib.fused_w4a4_lrc_smem_bytes.restype = ctypes.c_size_t
    return lib


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
        # V streams through a 32 KB buffer in 16-byte pieces, >= 8 rows a chunk
        if r > MAX_RANK or v.data_ptr() % 16:
            raise ValueError(f"v must have rank <= {MAX_RANK} and a 16-byte "
                             f"aligned start; got R={r}, address "
                             f"{v.data_ptr():#x}")
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
    _check(x, v, wpacked, sw, u, bits)
    m, k = x.shape
    if rotate:
        check_width(k)
    if group is not None:
        check_group(k, group)
    n = wpacked.shape[1]
    r = 0 if v is None else v.shape[1]
    need = smem_bytes(k, r, group)
    if need > SMEM_LIMIT:
        raise ValueError(f"(K={k}, R={r}, group={group}) needs {need} bytes of "
                         f"shared memory per block; the limit is {SMEM_LIMIT}")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    rc = _lib(KERNEL).fused_w4a4_lrc(
        x.data_ptr(), int(x.dtype == torch.bfloat16),
        None if v is None else v.data_ptr(), wpacked.data_ptr(),
        sw.data_ptr(), None if u is None else u.data_ptr(),
        int(v is not None and v.dtype == torch.bfloat16), out.data_ptr(),
        m, k, n, r, group or 0, 2 ** (bits - 1) - 1, float(clip_ratio), int(rotate),
        build.stream_of(x))
    if rc != 0:
        raise RuntimeError(f"fused_w4a4_lrc launch failed: cudaError {rc} "
                           f"at (M={m}, K={k}, N={n}, R={r}, group={group})")
    LAUNCHES["fused_w4a4_lrc"] += 1
    return out

"""W4A4 GEMM with the low-rank epilogue on Hopper, its plain version and
its launch counters.

The kernel (``csrc/w4a4_lowrank_matmul.cu``, CUDA C++ for sm_90a) replaces
the TPU kernel ``repro/kernels/w4a4.py::w4a4_lowrank_matmul_kernel``:

    out = (xq · unpack(Wp)) · sx · sw  +  xv · Uᵀ        (M, N) f32

from precomputed xq/sx (``fused_prologue`` or ``act_quant``) and xv; with
``group`` g, sx is the (M, K/g) scale plane and the GEMM dequantizes in the
K loop in ``rowops.gemm_grouped``'s canonical order, bitwise at any launch
geometry.  It is the GEMM of the chained and unfused paths
(``kernels/ops.py``).

Bound on an H100 SXM (3.35 TB/s): at decode the call is memory-bound; its
bytes are K·N/2 (packed W) + 4·N (sw) + 2·R·N (bf16 U) plus the
activations, e.g. 12.6 MB (3.8 us) at Phi-3-mini's K=8192, N=3072, R=307.
The design streams K through shared memory in fixed chunks, so its
footprint does not grow with K, and splits K across blocks at decode (exact
int32 partials, added by the last block); the source's head comment says
what it does and what later work should change.

:func:`w4a4_lowrank_matmul` is the wrapper: a CPU tensor runs
:func:`w4a4_lowrank_matmul_plain`; a CUDA tensor launches the kernel or
raises.  ``LAUNCHES`` counts each.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rowops import check_group, gemm_lowrank, unpack_int4_rows

KERNEL = "w4a4_lowrank_matmul"
LAUNCHES = {"w4a4_lowrank_matmul": 0, "w4a4_lowrank_matmul_plain": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


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
    lib.w4a4_lowrank_matmul.argtypes = [p, p, p, p, p, p, i, p, p, i, i, i, i, i, p]
    lib.w4a4_lowrank_matmul.restype = ctypes.c_int
    lib.w4a4_lowrank_matmul_scratch_bytes.argtypes = [i, i, i, i]
    lib.w4a4_lowrank_matmul_scratch_bytes.restype = ctypes.c_size_t
    return lib


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
    _check(xq, sx, wpacked, sw, xv, u, group)
    m, k = xq.shape
    n = wpacked.shape[1]
    r = 0 if xv is None else xv.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    if m == 0 or n == 0:
        return out
    lib = _lib(KERNEL)
    scratch = torch.empty(lib.w4a4_lowrank_matmul_scratch_bytes(m, k, n, group or 0),
                          dtype=torch.uint8, device=xq.device)
    rc = lib.w4a4_lowrank_matmul(
        xq.data_ptr(), sx.data_ptr(), wpacked.data_ptr(), sw.data_ptr(),
        None if xv is None else xv.data_ptr(),
        None if u is None else u.data_ptr(),
        int(u is not None and u.dtype == torch.bfloat16), out.data_ptr(),
        scratch.data_ptr() if scratch.numel() else None, m, k, n, r, group or 0,
        build.stream_of(xq))
    if rc != 0:
        raise RuntimeError(f"w4a4_lowrank_matmul launch failed: cudaError {rc} "
                           f"at (M={m}, K={k}, N={n}, R={r}, group={group})")
    LAUNCHES["w4a4_lowrank_matmul"] += 1
    return out

"""Per-token row bodies of the W4A4+LRC prologue and GEMM, in torch.

Counterpart of the per-token bodies in ``repro/kernels/rowops.py``.  These
are THE operation order the fused kernel follows and its plain version
runs: zero-guarded amax → ``s = (clip·amax)/qmax`` → ``q = clip(round(x/s))``
(a true division, rounding half to even), the int4 nibble layout, and the
K-chunked, R-tiled (x·V) projection; the online Walsh-Hadamard rotation
(:func:`fwht_rows`); and the one group dequant body
(:func:`dequant_rows_grouped`) of the quantized KV cache.  Group-wise
activation scales are not ported yet.
"""

from __future__ import annotations

import torch


def round_pow2(m: int) -> int:
    """Largest power of two ≤ max(m, 8) (block-size clamp helper)."""
    p = 8
    while p * 2 <= m:
        p *= 2
    return p


def default_proj_tiles(k: int, r: int, bk=None, br=None):
    """Default (bk, br) projection tiles: 512-capped powers of two clamped
    to the problem."""
    if bk is None:
        bk = min(512, round_pow2(max(k, 8)))
    if br is None:
        br = min(512, round_pow2(max(r, 8)))
    return bk, br


def scalar(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d tensor of ``like``'s dtype on its device.

    Arithmetic takes scalars in this form, never as Python numbers: the
    scalar then rounds to the tensor's dtype first, as a weakly typed JAX
    scalar does, and on CUDA a division by a Python number is computed as a
    multiplication by its rounded reciprocal, which is not ``x / s``."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def fwht_rows(y: torch.Tensor, d: int) -> torch.Tensor:
    """Normalized Walsh-Hadamard transform over the last axis of a (bm, d)
    f32 tile, d a power of two: sweeps h = 1, 2, ... d/2, each ``(a + b,
    a - b)`` over the (bm, d/2h, 2, h) reshape, then ONE multiply by the f32
    value of ``1.0 / d**0.5``.

    This is the kernels' operation order (the reference's ``fwht_rows``,
    which every rotating kernel and the jitted transform share).  It is not
    ``core/hadamard.fwht``, which divides by ``sqrt(d)``: the two differ in
    the last bit when d is 2·4^k (512, 2048, 8192)."""
    bm = y.shape[0]
    h = 1
    while h < d:
        y = y.reshape(bm, d // (2 * h), 2, h)
        a = y[:, :, 0, :]
        b = y[:, :, 1, :]
        y = torch.stack([a + b, a - b], dim=2)
        h *= 2
    return y.reshape(bm, d) * scalar(1.0 / d**0.5, y)


def row_amax(x: torch.Tensor) -> torch.Tensor:
    """Per-token |x| max of a (bm, d) tile -> (bm, 1)."""
    return x.abs().amax(dim=-1, keepdim=True)


def amax_to_scale(amax: torch.Tensor, qmax: int, clip_ratio: float):
    """Paper §2 scale: zero-guarded amax → s = c·amax/qmax."""
    amax = torch.where(amax <= 0.0, torch.ones_like(amax), amax)
    return scalar(clip_ratio, amax) * amax / scalar(qmax, amax)


def quantize_rows(x: torch.Tensor, s: torch.Tensor, qmax: int) -> torch.Tensor:
    """Elementwise q = clip(round(x/s)) on the symmetric int grid."""
    return torch.clamp(torch.round(x / s), -qmax - 1, qmax).to(torch.int8)


def scale_round_quantize(x: torch.Tensor, qmax: int, clip_ratio: float,
                         group: int = None):
    """amax → scale → round.  Per-token only: returns (q int8, s f32 (bm, 1))."""
    if group is not None:
        raise NotImplementedError(
            "group-wise activation scales are not ported yet (ROADMAP Queue 1)")
    s = amax_to_scale(row_amax(x), qmax, clip_ratio)
    return quantize_rows(x, s, qmax), s


def project_chunk_rows(x_chunk: torch.Tensor, v_tile: torch.Tensor):
    """ONE (bm, bk) × (bk, br) projection partial.  f32 in, f32 out."""
    return x_chunk @ v_tile.to(torch.float32)


def project_rows_tiled(x: torch.Tensor, v: torch.Tensor, bk: int, br: int):
    """The K-chunked, R-tiled (x·V): per R-tile, sum the per-chunk dots in
    ascending-K order.  x: (bm, k_pad) f32, v: (k_pad, r_pad); both padded
    to the tile multiples."""
    k_pad = x.shape[1]
    r_pad = v.shape[1]
    if k_pad % bk or r_pad % br:
        raise ValueError(f"operands not padded to tiles: {(k_pad, r_pad, bk, br)}")
    cols = []
    for rr in range(r_pad // br):
        acc = None
        for kk in range(k_pad // bk):
            part = project_chunk_rows(
                x[:, kk * bk:(kk + 1) * bk],
                v[kk * bk:(kk + 1) * bk, rr * br:(rr + 1) * br])
            acc = part if acc is None else acc + part
        cols.append(acc)
    return cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)


def project_rows(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(x·V) of a (bm, k) f32 row tile in :func:`project_rows_tiled`'s order
    at the default tiles (zero padding, then cut back to a contiguous
    (bm, r)).  The fused, chained and unfused plain versions all project
    through here, so their xv are bitwise the same."""
    k, r = x.shape[1], v.shape[1]
    bk, br = default_proj_tiles(k, r)
    k_pad, r_pad = k + (-k) % bk, r + (-r) % br
    xp = torch.nn.functional.pad(x, (0, k_pad - k))
    vp = torch.nn.functional.pad(v.to(torch.float32),
                                 (0, r_pad - r, 0, k_pad - k))
    return project_rows_tiled(xp, vp, bk, br)[:, :r].contiguous()


def rescale_lowrank(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
                    xv=None, u=None) -> torch.Tensor:
    """The GEMM epilogue ``acc·sx·sw (+ xv·Uᵀ)`` in f32: int32 acc (M, N),
    sx (M, 1), sw (N,) or (1, N), xv (M, R) f32, u (N, R) any float."""
    out = acc.to(torch.float32) * sx * sw.reshape(1, -1)
    if xv is not None:
        out = out + xv @ u.to(torch.float32).T
    return out


def dequant_rows_grouped(q: torch.Tensor, s: torch.Tensor,
                         group: int) -> torch.Tensor:
    """THE group dequant body: int rows (bm, d) and the (bm, d // group)
    scale plane → f32 rows, as ONE f32 multiply over the group reshape.
    Every consumer of a quantized KV cache dequantizes through here
    (``serve/kvquant.dequantize_kv``), and the CUDA attention kernel does
    the same single multiply per element, so their operands are bitwise
    the same."""
    bm, d = q.shape
    if d % group:
        raise ValueError(f"group {group} does not divide the row width {d}")
    x = q.to(torch.float32).reshape(bm, d // group, group) * s[..., None]
    return x.reshape(bm, d)


def unpack_int4_rows(wp: torch.Tensor) -> torch.Tensor:
    """(BK//2, BN) uint8 -> (BK, BN) int8 in [-8, 7]; even rows = low nibble.
    The sign of a nibble u is (u XOR 8) - 8."""
    lo = ((wp & 0xF) ^ 8).to(torch.int8) - 8
    hi = (((wp >> 4) & 0xF) ^ 8).to(torch.int8) - 8
    bk2, bn = wp.shape
    return torch.stack([lo, hi], dim=1).reshape(bk2 * 2, bn)


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product of int8 operands, returned as int32.

    Computed in float64: every product and partial sum of int8 × int4 codes
    is an integer far below 2**53, so any summation order is exact.  (PyTorch
    has no int32 matrix product on CUDA; this is the plain spelling the
    reference's int32 ``dot`` maps to on both devices.)"""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)

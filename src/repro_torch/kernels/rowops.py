"""Row bodies of the W4A4+LRC prologue and GEMM, in torch.

Counterpart of the bodies in ``repro/kernels/rowops.py``.  These are THE
operation order the kernels follow and their plain versions run: zero-guarded amax → ``s = (clip·amax)/qmax`` → ``q = clip(round(x/s))``
(a true division, rounding half to even), the int4 nibble layout, and the
K-chunked, R-tiled (x·V) projection; the online Walsh-Hadamard rotation
(:func:`fwht_rows`); and the one group dequant body
(:func:`dequant_rows_grouped`) of the quantized KV cache.

Group-wise activation scales (paper Table 2, g = 128) replace the (bm, 1)
per-token scale with a (bm, d/g) scale plane, one scale per g contiguous
K features (:func:`group_amax`, :func:`quantize_rows_grouped`).  The GEMM
then rescales each group's exact int32 partial before an f32 sum, whose
value depends on the order of its terms.  :func:`gemm_grouped` spells the
port's one canonical order: per group in ascending K, ``fl(partial · s_g)``
added to an f32 sum that starts at 0, one rounding per multiply and per
add; the epilogue then multiplies by ``sw`` (:func:`lowrank_epilogue`).
Every grouped kernel follows it whatever its launch geometry (grid,
K-split, row tile, M), so its output is bitwise this body's and a row's
result does not depend on its co-tenants or the prefill chunk.  With g = K
the sum is one term and the result is bitwise the per-token one.  The
reference's ``gemm_chunk_grouped`` sums each K-chunk's groups in one
``dot_general`` and then adds the chunks, another order: the two agree to
f32 rounding, not bitwise.  The reference's ``snap_bk_to_group`` and its
scale-plane padding have no counterpart: the port's plan carries no tiles
and its kernels mask ragged edges.
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


def check_group(k: int, group: int) -> None:
    """Raises unless ``group`` is a positive int that divides K."""
    if isinstance(group, bool) or not isinstance(group, int) or group <= 0 or k % group:
        raise ValueError(f"act_group {group!r} must be a positive int dividing K={k}")


def group_amax(x: torch.Tensor, group: int) -> torch.Tensor:
    """Per-group |x| max of a (bm, d) tile -> (bm, d // group), groups
    contiguous along K."""
    bm, d = x.shape
    check_group(d, group)
    return x.abs().reshape(bm, d // group, group).amax(dim=-1)


def quantize_rows_grouped(x: torch.Tensor, s: torch.Tensor, qmax: int,
                          group: int) -> torch.Tensor:
    """Elementwise q = clip(round(x/s)) with one scale per K group (the
    (bm, d // group) plane ``s``)."""
    bm, d = x.shape
    xs = x.reshape(bm, d // group, group) / s[..., None]
    return torch.clamp(torch.round(xs), -qmax - 1, qmax).to(torch.int8).reshape(bm, d)


def scale_round_quantize(x: torch.Tensor, qmax: int, clip_ratio: float,
                         group: int = None):
    """amax → scale → round.  Per-token (``group`` None) returns (q int8,
    s f32 (bm, 1)); group-wise the (bm, d // group) scale plane instead."""
    if group is None:
        s = amax_to_scale(row_amax(x), qmax, clip_ratio)
        return quantize_rows(x, s, qmax), s
    s = amax_to_scale(group_amax(x, group), qmax, clip_ratio)
    return quantize_rows_grouped(x, s, qmax, group), s


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


def lowrank_epilogue(out: torch.Tensor, sw: torch.Tensor, xv=None,
                     u=None) -> torch.Tensor:
    """``out·sw (+ xv·Uᵀ)`` in f32, where ``out`` (M, N) f32 already holds
    the activation scales: sw (N,) or (1, N), xv (M, R) f32, u (N, R) any
    float."""
    out = out * sw.reshape(1, -1)
    if xv is not None:
        out = out + xv @ u.to(torch.float32).T
    return out


def rescale_lowrank(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
                    xv=None, u=None) -> torch.Tensor:
    """The per-token GEMM epilogue ``(acc·sx)·sw (+ xv·Uᵀ)`` in f32: int32
    acc (M, N), sx (M, 1), the rest as :func:`lowrank_epilogue`."""
    return lowrank_epilogue(acc.to(torch.float32) * sx, sw, xv, u)


def gemm_grouped(xq: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
                 group: int) -> torch.Tensor:
    """THE canonical group-rescaled int GEMM: xq (M, K) int8, w (K, N) int8
    codes, s the (M, K // group) f32 scale plane -> (M, N) f32
    ``Σ_g fl(p_g · s_g)``, p_g the exact int32 partial over group g, added
    in ascending g to an f32 sum that starts at 0 (module docstring).  Each
    multiply and add is a separate rounded torch operation, so nothing is
    contracted into an FMA."""
    m, k = xq.shape
    check_group(k, group)
    if tuple(s.shape) != (m, k // group):
        raise ValueError(f"the scale plane must be ({m}, {k // group}); got "
                         f"{tuple(s.shape)}")
    out = torch.zeros((m, w.shape[1]), dtype=torch.float32, device=xq.device)
    for g in range(k // group):
        part = int_matmul(xq[:, g * group:(g + 1) * group], w[g * group:(g + 1) * group])
        out = out + part.to(torch.float32) * s[:, g:g + 1]
    return out


def gemm_lowrank(xq: torch.Tensor, w: torch.Tensor, sx: torch.Tensor,
                 sw: torch.Tensor, xv=None, u=None, group: int = None) -> torch.Tensor:
    """The whole W4A4 GEMM with its epilogue on int8 codes xq (M, K) and w
    (K, N): per-token (``sx`` (M, 1)) :func:`rescale_lowrank` of the exact
    int GEMM, group-wise (``sx`` the (M, K // group) plane)
    :func:`gemm_grouped` then :func:`lowrank_epilogue`."""
    if group is None:
        return rescale_lowrank(int_matmul(xq, w), sx, sw, xv, u)
    return lowrank_epilogue(gemm_grouped(xq, w, sx, group), sw, xv, u)


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

"""The tensor-core W4A4 GEMM (#2, ``csrc/w4a4_lowrank_matmul.cu``) emulated
on the CPU in numpy, word for word where the kernel works on 32-bit words:

* the nibble expansion of a B fragment (byte permutes, then the borrow-free
  byte-wise (nib ^ 8) - 8) is bitwise ``rowops.unpack_int4_rows`` over
  every byte value and over random words;
* a warp's k-steps through the PTX m16n8k32 fragment layout, with the
  kernel's permutation of k inside a k-step and its byte-masked pieces
  where a group boundary cuts a k-step, give the exact int32 partials of
  ``rowops.gemm_grouped``'s groups (g 32, 64, 128, and 40, 8, 10, 200 at
  K 200), and its f32 group sum bitwise;
* ``w4a4.gemm_plan`` depends on shapes alone, covers every stage with its
  K-splits, and its scratch covers every split it makes at the served and
  benchmarked sites;
* the epilogue's order (the exact int GEMM, two rounded multiplies, the LR
  term as one fmaf chain a output over ascending ranks, emulated in f64
  rounded to f32 at every step, then one rounded add) holds within the
  unchanged ``bench.common.gemm_tolerance`` of the plain version.

The kernel itself runs only on the card (``chip_smoke.py`` phases 2, 3, 12
and 13 build it, count its IMMA instructions and hold it against its plain
version)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.bench.common import gemm_tolerance
from repro_torch.core.quantizers import pack_int4
from repro_torch.kernels import w4a4
from repro_torch.kernels.rowops import gemm_grouped, int_matmul, unpack_int4_rows

U32 = np.uint32


def byte_perm(x, y, s: int):
    """CUDA's __byte_perm(x, y, s) on uint32 arrays: byte i of the result is
    byte (selector nibble i) of the eight bytes y:x."""
    v = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros_like(x, dtype=U32)
    for i in range(4):
        sel = (s >> (4 * i)) & 7
        out |= ((v >> np.uint64(8 * sel)) & np.uint64(0xFF)).astype(U32) << U32(8 * i)
    return out


def low_nibble_codes(z):
    """The kernel's low_nibble_codes: the signed int4 codes of the low nibbles
    of z's four bytes, one int8 a byte, without borrows between bytes."""
    z = z.astype(U32)
    return (((z & U32(0x0F0F0F0F)) ^ U32(0x88888888)) - U32(0x08080808)) ^ U32(0x80808080)


def b_fragments(w):
    """The kernel's b_fragments: w[i] (i < 4) the packed words of rows 4t + i
    at columns c..c+3 -> b[j][h], the int8 codes k = 8t + 4h .. 8t + 4h + 3
    of column c + j as one word each."""
    b = [[None, None] for _ in range(4)]
    for h in range(2):
        lo = byte_perm(w[2 * h], w[2 * h + 1], 0x5140)
        hi = byte_perm(w[2 * h], w[2 * h + 1], 0x7362)
        b[0][h] = low_nibble_codes(byte_perm(lo, lo >> U32(4), 0x5140))
        b[1][h] = low_nibble_codes(byte_perm(lo, lo >> U32(4), 0x7362))
        b[2][h] = low_nibble_codes(byte_perm(hi, hi >> U32(4), 0x5140))
        b[3][h] = low_nibble_codes(byte_perm(hi, hi >> U32(4), 0x7362))
    return b


def word_bytes(w):
    """uint32 words -> their four bytes as int8, little-endian, on a new
    last axis."""
    return np.stack([((w >> U32(8 * i)) & U32(0xFF)).astype(np.uint8).view(np.int8)
                     for i in range(4)], axis=-1)


def words_of(rows):
    """(..., 4) uint8 bytes -> uint32 words, little-endian."""
    r = rows.astype(U32)
    return r[..., 0] | (r[..., 1] << U32(8)) | (r[..., 2] << U32(16)) | (r[..., 3] << U32(24))


def fragments_of(wp):
    """B fragments of a whole (16·k-steps, 4·cols) packed W, as the kernel's
    thread (g, t) builds them: for k-step s, thread t and word column cw,
    b[j][h] of column 4·cw + j."""
    kp, n = wp.shape
    rows = wp.reshape(kp // 16, 4, 4, n // 4, 4)  # (s, t, i, cw, byte)
    w = [words_of(rows[:, :, i]) for i in range(4)]  # each (s, t, cw)
    return b_fragments(w)


@pytest.mark.parametrize("what", ["every byte", "random words"])
def test_nibble_expansion_is_unpack(what):
    """The B fragments' codes, byte by byte, are the unpacked codes of the
    packed rows 4t..4t+3 of their column: lo, hi nibble of row 4t, of 4t+1
    for b[.][0]; of 4t+2, 4t+3 for b[.][1]."""
    rng = np.random.default_rng(0)
    if what == "every byte":
        # 256 byte values as 16 blocks of 4 packed rows x 4 columns, each value
        # in each of the 16 positions of a block over the blocks
        base = np.arange(256, dtype=np.uint8).reshape(16, 16)
        blocks = np.stack([np.roll(base, s, axis=1) for s in range(16)])  # (16, 16, 16)
        wp = blocks.reshape(16 * 16, 4, 4).transpose(1, 0, 2).reshape(4, 16 * 16 * 4)
        wp = np.tile(wp, (4, 1))  # 16 packed rows: one k-step
    else:
        wp = rng.integers(0, 256, size=(16 * 8, 4 * 64), dtype=np.uint8)
    b = fragments_of(wp)
    codes = unpack_int4_rows(torch.from_numpy(wp)).numpy()  # (K, N)
    kp, n = wp.shape
    for j in range(4):
        for h in range(2):
            got = word_bytes(b[j][h])  # (s, t, cw, 4)
            for s in range(kp // 16):
                for t in range(4):
                    k = 32 * s + 8 * t + 4 * h
                    want = codes[k:k + 4, j::4].T  # (cw, 4)
                    assert np.array_equal(got[s, t], want)
    # the byte-wise sign extension alone, every nibble in every byte
    z = np.arange(256, dtype=U32)
    for pos in range(4):
        got = word_bytes(low_nibble_codes(z << U32(8 * pos)))[:, pos].astype(np.int32)
        assert np.array_equal(got, ((z & 15) ^ 8).astype(np.int32) - 8)


def byte_mask(b: int, e: int) -> int:
    """The kernel's byte_mask: bytes [b, e) of a word, b and e clamped to
    [0, 4]."""
    b, e = max(b, 0), min(e, 4)
    if b >= e:
        return 0
    hi = 0xFFFFFFFF if e >= 4 else (1 << (8 * e)) - 1
    return hi & ~((1 << (8 * b)) - 1) & 0xFFFFFFFF


def mma(a, b0, b1):
    """One m16n8k32 s8 mma of the PTX layout, from the fragments of its 32
    threads: a[g][t] = (A(g, 4t..), A(g+8, 4t..), A(g, 16+4t..),
    A(g+8, 16+4t..)) words, b0/b1[g][t] words of B(4t.., g), B(16+4t.., g).
    Returns D (16, 8) int64."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for g in range(8):
        for t in range(4):
            A[g, 4 * t:4 * t + 4] = word_bytes(np.array(a[g][t][0], U32))
            A[g + 8, 4 * t:4 * t + 4] = word_bytes(np.array(a[g][t][1], U32))
            A[g, 16 + 4 * t:20 + 4 * t] = word_bytes(np.array(a[g][t][2], U32))
            A[g + 8, 16 + 4 * t:20 + 4 * t] = word_bytes(np.array(a[g][t][3], U32))
            B[4 * t:4 * t + 4, g] = word_bytes(np.array(b0[g][t], U32))
            B[16 + 4 * t:20 + 4 * t, g] = word_bytes(np.array(b1[g][t], U32))
    return A @ B


def warp_group_partials(xq, wp, group):
    """One warp's 16 x 32 tile (rows 0..15, columns 0..31) over all of K as
    the kernel runs it: per k-step, A by one 8-byte load a row and thread
    (codes 8t..8t+7), B by b_fragments, one mma per piece of the k-step a
    group boundary leaves, the bytes outside the piece masked off A; each
    group's partial taken where the group ends.  Returns {g: (16, 32)
    int64} of the output columns (thread (g, t)'s n8 tile j holds column
    4g + j)."""
    m, k = xq.shape
    ksteps = -(-k // 32)
    xpad = np.zeros((16, 32 * ksteps), np.int8)
    xpad[:m, :k] = xq
    wpad = np.zeros((16 * ksteps, 32), np.uint8)
    wpad[:k // 2] = wp
    frags = fragments_of(wpad)  # b[j][h]: (s, t, cw)
    acc = np.zeros((16, 32), np.int64)
    parts = {}
    gcur, gend = 0, group
    for s in range(ksteps):
        kk = 32 * s
        rows = xpad[:, kk:kk + 32].view(np.uint8).reshape(16, 8, 4)
        words = words_of(rows)  # (row, word): codes 4w..4w+3
        kp = kk
        while kp < min(kk + 32, k):
            e = min(gend, kk + 32)
            a = [[None] * 4 for _ in range(8)]
            for g in range(8):
                for t in range(4):
                    base = kk + 8 * t
                    lo_m = byte_mask(kp - base, e - base)
                    hi_m = byte_mask(kp - base - 4, e - base - 4)
                    a[g][t] = (int(words[g, 2 * t]) & lo_m, int(words[g + 8, 2 * t]) & lo_m,
                               int(words[g, 2 * t + 1]) & hi_m, int(words[g + 8, 2 * t + 1]) & hi_m)
            for j in range(4):
                b0 = [[int(frags[j][0][s, t, g]) for t in range(4)] for g in range(8)]
                b1 = [[int(frags[j][1][s, t, g]) for t in range(4)] for g in range(8)]
                acc[:, j::4] += mma(a, b0, b1)  # n8 tile j: columns 4g + j
            if e == gend:
                parts[gcur] = acc.copy()
                acc[:] = 0
                gcur, gend = gcur + 1, gend + group
            kp = e
    return parts


@pytest.mark.parametrize("k,group", [(256, 32), (256, 64), (384, 128), (200, 40), (200, 8),
                                     (200, 10), (200, 200), (90, 45)])
def test_masked_pieces_give_group_partials(k, group):
    """The warp's group partials are gemm_grouped's exact int32 partials, so
    its f32 group sum (ascending g from 0, each product and add rounded) is
    gemm_grouped's output bitwise."""
    rng = np.random.default_rng(k + group)
    m, n = 16, 32
    xq = rng.integers(-8, 8, size=(m, k), dtype=np.int8)
    w = rng.integers(-8, 8, size=(k, n), dtype=np.int8)
    wp = pack_int4(torch.from_numpy(w).T).T.contiguous().numpy()
    assert np.array_equal(unpack_int4_rows(torch.from_numpy(wp)).numpy(), w)
    parts = warp_group_partials(xq, wp, group)
    assert sorted(parts) == list(range(k // group))
    for g, p in parts.items():
        want = int_matmul(torch.from_numpy(xq[:, g * group:(g + 1) * group]),
                          torch.from_numpy(w[g * group:(g + 1) * group])).numpy()
        assert np.array_equal(p, want)
    s = rng.random((m, k // group), dtype=np.float32) + np.float32(0.01)
    gsum = np.zeros((m, n), np.float32)
    for g in range(k // group):
        gsum = (gsum + (parts[g].astype(np.float32) * s[:, g:g + 1]).astype(np.float32)
                ).astype(np.float32)
    want = gemm_grouped(torch.from_numpy(xq), torch.from_numpy(w), torch.from_numpy(s),
                        group).numpy()
    assert np.array_equal(gsum, want)


# Phi-3-mini's, Gemma-7b's and phase 12's (K, N) sites, and ragged ones
PLAN_SITES = [(3072, 3072), (3072, 8192), (8192, 3072), (3072, 4096), (4096, 3072),
              (3072, 24576), (24576, 3072), (4096, 11008), (5120, 13824), (8192, 28672),
              (200, 97), (90, 33), (3072, 3073), (8194, 1), (16384, 130)]


@pytest.mark.parametrize("m", [1, 4, 16, 100, 2048])
def test_gemm_plan_covers_its_splits(m):
    """The plan is a function of shapes and the SM count alone; its splits
    cover every stage once; its scratch covers, for every split it makes,
    the tickets and group plane (zeroed) and the per-token partials and LR
    terms (scratch), in the layout the source indexes."""
    for (k, n) in PLAN_SITES:
        for group in (None, 128, 64, k):
            if group and k % group:
                continue
            p = w4a4.gemm_plan(m, k, n, group)
            assert p == w4a4.gemm_plan(m, k, n, group)
            assert p.decode == (m <= w4a4.DECODE_M)
            assert p.tiles_n * w4a4.BN >= n > (p.tiles_n - 1) * w4a4.BN
            assert p.tiles_m * p.bm >= m > (p.tiles_m - 1) * p.bm
            assert p.stages == -(-k // (w4a4.DECODE_BK if p.decode else w4a4.LARGE_BK))
            assert (p.splits - 1) * p.stages_per_split < p.stages <= p.splits * p.stages_per_split
            if not p.decode:
                assert p.splits == 1 and p.zeroed_bytes == p.scratch_bytes == 0
                continue
            planes = p.tiles_n * (k // group) * m * w4a4.BN if group and p.splits > 1 else 0
            parts = p.tiles_n * p.splits * m * w4a4.BN if not group and p.splits > 1 else 0
            assert p.zeroed_bytes >= 4 * (p.tiles_n * w4a4.LR_BLOCKS + planes)
            assert p.scratch_bytes >= 4 * (parts + m * p.tiles_n * w4a4.BN)
            # more SMs never fewer splits at decode; the bounds of a block
            more = w4a4.gemm_plan(m, k, n, group, sms=2 * w4a4.H100_SMS)
            assert more.splits >= p.splits
            assert p.threads * p.smem_bytes > 0 and p.smem_bytes <= 227 * 1024


def test_scratch_is_cached_and_grows():
    """One zeroed and one plain buffer per (device, stream), reused while
    large enough and grown, zeroed, when a call needs more."""
    dev = torch.device("cpu")
    key = (dev.index, -1)
    w4a4._SCRATCH.pop(key, None)
    z1, s1 = w4a4._scratch(dev, -1, 64, 32)
    z2, s2 = w4a4._scratch(dev, -1, 16, 8)
    assert (z1, s1) == (z2, s2)
    z3, _ = w4a4._scratch(dev, -1, 4096, 8)
    zeroed = w4a4._SCRATCH[key][0]
    assert zeroed.numel() == 4096 and not zeroed.any() and z3 == zeroed.data_ptr()
    assert w4a4._scratch(dev, -1, 0, 0) == (None, None)
    w4a4._SCRATCH.pop(key)


def _fmaf_chain(xv, u):
    """lr = fmaf(xv[m, r], u[n, r], lr) over r ascending from 0.f, each step
    in f64 then rounded to f32 (the product of two f32 is exact in f64)."""
    lr = np.zeros((xv.shape[0], u.shape[0]), np.float32)
    for r in range(xv.shape[1]):
        lr = (np.outer(xv[:, r].astype(np.float64), u[:, r].astype(np.float64))
              + lr.astype(np.float64)).astype(np.float32)
    return lr


@pytest.mark.parametrize("m,k,n,r,group", [(4, 256, 64, 37, None), (16, 512, 40, 64, None),
                                           (3, 200, 33, 7, 40), (5, 384, 16, 96, 128)])
def test_epilogue_order_within_gemm_tolerance(m, k, n, r, group):
    """The kernel's epilogue order against the plain version: bitwise
    without the LR term, within gemm_tolerance with it."""
    rng = np.random.default_rng(m * k + n + r)
    xq = rng.integers(-8, 8, size=(m, k), dtype=np.int8)
    w = rng.integers(-8, 8, size=(k, n), dtype=np.int8)
    wp = pack_int4(torch.from_numpy(w).T).T.contiguous()
    sw = (rng.random(n, dtype=np.float32) * np.float32(0.02) + np.float32(0.001))
    xv = rng.standard_normal((m, r)).astype(np.float32)
    u = torch.from_numpy(rng.standard_normal((n, r)).astype(np.float32) * 0.05).to(torch.bfloat16)
    uf = u.float().numpy()
    if group is None:
        sx = rng.random((m, 1), dtype=np.float32) + np.float32(0.01)
        acc = int_matmul(torch.from_numpy(xq), torch.from_numpy(w)).numpy()
        o = ((acc.astype(np.float32) * sx).astype(np.float32) * sw).astype(np.float32)
    else:
        sx = rng.random((m, k // group), dtype=np.float32) + np.float32(0.01)
        gs = gemm_grouped(torch.from_numpy(xq), torch.from_numpy(w), torch.from_numpy(sx),
                          group).numpy()
        o = (gs * sw).astype(np.float32)
    plain0 = w4a4.w4a4_lowrank_matmul_plain(torch.from_numpy(xq), torch.from_numpy(sx), wp,
                                            torch.from_numpy(sw), group=group).numpy()
    assert np.array_equal(o, plain0)
    y = (o + _fmaf_chain(xv, uf)).astype(np.float32)
    y_plain = w4a4.w4a4_lowrank_matmul_plain(torch.from_numpy(xq), torch.from_numpy(sx), wp,
                                             torch.from_numpy(sw), torch.from_numpy(xv), u,
                                             group)
    tol = gemm_tolerance(torch.from_numpy(xv), u, r, y_plain).numpy()
    assert np.all(np.abs(y - y_plain.numpy()) <= tol)

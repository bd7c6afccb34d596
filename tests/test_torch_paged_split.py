"""The split-KV order of the paged decode kernels #6/#9
(``csrc/paged_attention.cuh``), emulated in float32 torch on the CPU, held
to their accuracy standard (``flash_attn.paged_attention_bound``) against
the plain versions, which keep the reference's page-by-page order.

The emulation follows the body's order of operations: a row's keys in
splits of ``PAGES_PER_SPLIT`` pages, each split's tokens in steps of
(tokens a pass) × (passes a step) taken by ``SPLIT_WARPS`` warps in turn,
each warp with its own running max, l and acc; per step the scores (an
f32 product), the step's max, corr and p, Σp summed over a lane's passes
and then over the lane groups by an xor tree, acc's p·v as an fma chain
over a lane's passes (each fma emulated in f64, then rounded once) and
acc·corr + pv; the groups' acc by the xor tree after the last step; the
warps, then the splits, combined in ascending order with e_i = 1 where
m_i is the maximum; A / max(L, 1e-30) in q's dtype.  Only the order of
each score's D-term dot differs from the kernel's (the standard allows
any order there).

The inputs are a long ragged batch at Phi-3-mini's head dim (lengths 4096,
3000, 1024 and 17 over P 16, MPB 256: 16 splits), a few heads (H 4 over KH
2), f32 and bf16 q, over an f32 pool and an int8 pool dequantized by
``dequantize_kv``, with large finite garbage in every page no row owns.
The emulated rows are also checked bitwise invariant: alone with their
pages elsewhere, in the ragged batch, and in a wider block table (S 16
against S 1)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attn
from repro_torch.kernels.rowops import scalar
from repro_torch.serve.kvquant import KVSpec, dequantize_kv, quantize_kv

PAGE, MPB = 16, 256
LENGTHS = (4096, 3000, 1024, 17)
H, KH, D = 4, 2, 96
PPS = flash_attn.PAGES_PER_SPLIT
WARPS = flash_attn.SPLIT_WARPS
# the body's readers: elements a 16-byte vector and passes a step
READERS = {"f32": (4, 8), "bf16": (8, 4), "int8": (16, 4), "int4": (32, 2)}


def geometry(pool: str, d: int, dv: int):
    """(tokens a pass, passes a step) of the body for rows of whole 16-byte
    vectors: the wider row's vectors rounded up to a power of two lanes (at
    most 32) read one token."""
    e, passes = READERS[pool]
    nv = max(-(-d // e), -(-dv // e))
    lanes = 1
    while lanes < nv and lanes < 32:
        lanes *= 2
    return 32 // lanes, passes


def _tree(x):
    """The xor tree over dim 0 (a power of two long): x_i + x_(i ^ off) for
    off = 1, 2, …, every slot ending alike; returns slot 0."""
    off = 1
    while off < x.shape[0]:
        x = x + x[torch.arange(x.shape[0]) ^ off]
        off *= 2
    return x[0]


def _fma(a, b, c):
    """a·b + c rounded once to f32 (the exact product in f64)."""
    return (a.double() * b.double() + c.double()).float()


def _combine(states):
    """(m, l, acc) states merged in ascending order."""
    mx = states[0][0]
    for m, _, _ in states[1:]:
        mx = torch.maximum(mx, m)
    for i, (m, l, acc) in enumerate(states):
        e = torch.where(m == mx, torch.ones_like(m), torch.exp(m - mx))
        if i == 0:
            big_l, big_a = l * e, acc * e
        else:
            big_l, big_a = big_l + l * e, big_a + acc * e
    return mx, big_l, big_a


def emulate(q, k_pages, v_pages, block_table, lengths, scale, tp, passes):
    """The body's order (module docstring) over f32 pools (NP, P, KH, D|Dv);
    returns (B, H, Dv) in q's dtype (rows of length 0 as zeros)."""
    f32 = torch.float32
    b, h, d = q.shape
    page, kh, dv = k_pages.shape[1], k_pages.shape[2], v_pages.shape[3]
    g = h // kh
    mpb = block_table.shape[1]
    splits = flash_attn.paged_splits(mpb)
    step = tp * passes
    qf = q.to(f32).reshape(b, kh, g, d)
    qf = qf * scalar(scale, qf)
    out = torch.zeros((b, kh, g, dv), dtype=f32)
    for bi in range(b):
        n = max(0, min(int(lengths[bi]), mpb * page))
        ns = -(-(-(-n // page)) // PPS)
        parts = []
        for s in range(ns):
            t0 = s * PPS * page
            t1 = min(n, t0 + PPS * page)
            n_steps = -(-(t1 - t0) // step)
            states = []
            for w in range(WARPS):
                m = torch.full((kh, g, 1), flash_attn.NEG_INF, dtype=f32)
                l = torch.zeros((kh, g, 1), dtype=f32)
                acc = torch.zeros((tp, kh, g, dv), dtype=f32)
                for k in range(w, n_steps, WARPS):
                    pos = t0 + k * step + torch.arange(step)  # token i·tp + grp
                    ok = pos < t1
                    pos = torch.where(ok, pos, t0 + k * step)
                    pid = block_table[bi, pos // page].long()
                    kk = k_pages[pid, pos % page]
                    vv = torch.where(ok[:, None, None], v_pages[pid, pos % page], 0.0)
                    sc = qf[bi] @ kk.permute(1, 2, 0)  # (KH, G, step)
                    sc = torch.where(ok, sc, flash_attn.NEG_INF)
                    m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
                    corr = torch.exp(m - m_new)
                    p = torch.exp(sc - m_new).reshape(kh, g, passes, tp)
                    lane = p[:, :, 0]
                    for i in range(1, passes):
                        lane = lane + p[:, :, i]
                    l = l * corr + _tree(lane.permute(2, 0, 1))[..., None]
                    vr = vv.reshape(passes, tp, kh, 1, dv)
                    pt = p.permute(2, 3, 0, 1)[..., None]  # (passes, tp, KH, G, 1)
                    pv = pt[0] * vr[0]
                    for i in range(1, passes):
                        pv = _fma(pt[i], vr[i], pv)
                    acc = acc * corr + pv
                    m = m_new
                states.append((m, l, _tree(acc)))
            parts.append(_combine(states))
        if ns:
            _, big_l, big_a = parts[0] if splits == 1 else _combine(parts)
            out[bi] = big_a / torch.clamp_min(big_l, 1e-30)
    return out.reshape(b, h, dv).to(q.dtype)


def problem(seed, pool, lengths=LENGTHS, mpb=MPB):
    """q, the kernel's pools (f32 rows, or int8 codes and scales), the same
    pools as f32 (dequantized), the table and lengths; every page no row
    owns (the null page included) holds large finite garbage."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    need = [-(-n // PAGE) for n in lengths]
    n_pages = 1 + sum(need) + 4
    ids = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((b, mpb), np.int32)
    taken = 0
    for i, k in enumerate(need):
        table[i, :k] = ids[taken:taken + k]
        taken += k
    owned = torch.from_numpy(table[table > 0]).long()
    q = torch.from_numpy(rng.standard_normal((b, H, D)).astype(np.float32))
    spec = KVSpec("int8") if pool == "int8" else None
    pools, dense = [], []
    for _ in range(2):
        rows = torch.from_numpy(rng.standard_normal((n_pages, PAGE, KH, D)).astype(np.float32))
        junk = torch.from_numpy(
            (rng.standard_normal((n_pages, PAGE, KH, D)) * 40).astype(np.float32))
        junk[owned] = rows[owned]
        if spec is None:
            pools.append((junk,))
            dense.append(junk)
        else:
            codes, scales = quantize_kv(junk, spec)
            pools.append((codes, scales))
            dense.append(dequantize_kv(codes, scales, spec, D))
    return (q, pools, dense, torch.from_numpy(table),
            torch.tensor(lengths, dtype=torch.int32), spec)


def _plain(q, pools, table, lengths, spec):
    if spec is None:
        return flash_attn.paged_flash_attention_plain(q, pools[0][0], pools[1][0], table,
                                                      lengths, D ** -0.5)
    (kc, ks), (vc, vs) = pools
    return flash_attn.paged_flash_attention_quant_plain(q, kc, ks, vc, vs, table, lengths,
                                                        D ** -0.5, spec)


def _rows(pool_f32, table):
    """The rows' f32 K or V, (B, MPB·P, KH, ·), in position order."""
    b, mpb = table.shape
    return pool_f32[table.long()].reshape(b, mpb * PAGE, KH, -1)


@pytest.mark.parametrize("pool", ["f32", "int8"])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16], ids=["q32", "q16"])
def test_emulated_order_within_bound(pool, q_dtype):
    """The split order against the plain version's page order: every valid
    element within ``paged_attention_bound``, at 16 splits."""
    q, pools, dense, table, lengths, spec = problem(3, pool)
    q = q.to(q_dtype)
    tp, passes = geometry(pool, D, D)
    got = emulate(q, *dense, table, lengths, D ** -0.5, tp, passes)
    want = _plain(q, pools, table, lengths, spec)
    tol = flash_attn.paged_attention_bound(q, _rows(dense[0], table), _rows(dense[1], table),
                                           lengths, D ** -0.5, PAGE, want)
    err = (got.double() - want.double()).abs()
    assert torch.isfinite(got).all()
    assert (err <= tol).all(), (err / tol).max()


def test_bound_catches_a_combine_without_rescale():
    """A combine that adds the splits' acc and l without their factors
    e^(m_s - M) (a wrong order, not a rounding) falls far outside the
    bound: the standard is tight enough to see it."""
    global _combine
    q, pools, dense, table, lengths, spec = problem(4, "f32")
    tp, passes = geometry("f32", D, D)
    want = _plain(q, pools, table, lengths, spec)
    tol = flash_attn.paged_attention_bound(q, _rows(dense[0], table), _rows(dense[1], table),
                                           lengths, D ** -0.5, PAGE, want)
    right = _combine

    def unscaled(states):
        mx, _, _ = right(states)
        return (mx, sum(st[1] for st in states), sum(st[2] for st in states))

    _combine = unscaled
    try:
        got = emulate(q, *dense, table, lengths, D ** -0.5, tp, passes)
    finally:
        _combine = right
    err = (got.double() - want.double()).abs()
    assert (err > tol)[:2].any()  # the rows of more than one warp and split


@pytest.mark.parametrize("pool", ["f32", "int8"])
def test_emulated_row_is_bitwise_invariant(pool):
    """A row's emulated output is bitwise the same alone (B 1, its pages
    copied elsewhere), in the ragged batch, and in a wider table (MPB 4,
    S 1, against MPB 256, S 16)."""
    q, pools, dense, table, lengths, _ = problem(5, pool)
    tp, passes = geometry(pool, D, D)
    batch = emulate(q, *dense, table, lengths, D ** -0.5, tp, passes)
    need = -(-int(lengths[0]) // PAGE)
    n_pages = dense[0].shape[0]
    moved = [torch.cat([t, t[table[0, :need].long()]]) for t in dense]
    alone_table = torch.zeros((1, MPB), dtype=torch.int32)
    alone_table[0, :need] = n_pages + torch.arange(need, dtype=torch.int32)
    alone = emulate(q[:1], *moved, alone_table, lengths[:1], D ** -0.5, tp, passes)
    assert torch.equal(alone[0], batch[0])

    short = (64, 37, 13, 0)
    q, pools, dense, table, lengths, _ = problem(6, pool, short, mpb=4)
    narrow = emulate(q, *dense, table, lengths, D ** -0.5, tp, passes)
    wide_table = torch.zeros((len(short), MPB), dtype=torch.int32)
    wide_table[:, :4] = table
    wide = emulate(q, *dense, wide_table, lengths, D ** -0.5, tp, passes)
    assert flash_attn.paged_splits(4) == 1 and flash_attn.paged_splits(MPB) == 16
    assert torch.equal(narrow[:3], wide[:3])


@pytest.mark.parametrize("mpb, splits", [(0, 1), (1, 1), (4, 1), (16, 1), (17, 2),
                                         (40, 3), (256, 16), (257, 17)])
def test_splits_come_from_shapes(mpb, splits):
    """S = max(1, ceil(MPB / PAGES_PER_SPLIT)); the wrapper's workspace is
    (S, B, H, Dv + 2) f32 with S > 1, none with S 1."""
    assert flash_attn.paged_splits(mpb) == splits
    q = torch.zeros((3, 4, 8))
    part = flash_attn._workspace(q, mpb, 6)
    if splits == 1:
        assert part is None
    else:
        assert part.shape == (splits, 3, 4, 8) and part.dtype == torch.float32


def test_bound_counts_the_split():
    """The bound grows with the row's splits and steps, not with garbage
    outside it: rows of one split at MPB 4 and at MPB 256 get the same
    bound, and a bf16 output adds 2⁻⁶ of |plain|."""
    q, pools, dense, table, lengths, spec = problem(7, "f32", (64, 37, 13, 0), mpb=4)
    want = _plain(q, pools, table, lengths, spec)
    wide_table = torch.zeros((4, MPB), dtype=torch.int32)
    wide_table[:, :4] = table
    args = (q, _rows(dense[0], table), _rows(dense[1], table), lengths, D ** -0.5, PAGE)
    wide_args = (q, _rows(dense[0], wide_table), _rows(dense[1], wide_table), lengths,
                 D ** -0.5, PAGE)
    narrow = flash_attn.paged_attention_bound(*args, want)
    assert torch.equal(narrow, flash_attn.paged_attention_bound(*wide_args, want))
    assert (narrow[:3] > 0).all() and (narrow[3] == 0).all()
    half = want.to(torch.bfloat16)
    assert torch.allclose(flash_attn.paged_attention_bound(*args, half),
                          narrow + 2.0 ** -6 * half.double().abs())
    long_q, _, long_dense, long_table, long_lengths, _ = problem(8, "f32")
    long = flash_attn.paged_attention_bound(
        long_q, _rows(long_dense[0], long_table), _rows(long_dense[1], long_table),
        long_lengths, D ** -0.5, PAGE, torch.zeros_like(want))
    # the sums' term alone at 4096 tokens (n_w 64, ns 16, 256 pages):
    # 4·64 + 2·16 + 34 + 2·16 + 4·256 + 2 = 1380 units of u·max|v|, max|v| > 1
    assert (long[0] > 1380 * 2.0 ** -24).all()

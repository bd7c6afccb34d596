"""The prologue kernel's launch plan and its x·V order (#3,
``csrc/fused_prologue.cu``), on the CPU:

* ``prologue.prologue_plan`` depends on shapes alone, and the blocks it
  launches compute every (row, column, sub-chunk) chain exactly once, in
  the V stream and in the register tiles, at ragged K, M and R, rotated or
  not, with the K split or not;
* the scratch the wrapper hands the kernel is cached per (device, stream)
  and grows;
* a model of the kernel's tickets (each output tile's blocks take one in
  any order, the last resets it) leaves every ticket at zero after each of
  two launches in a row, with exactly one finishing block a tile;
* the kernel's x·V order, emulated by walking the plan's blocks (chains of
  fmaf over each sub-chunk's eighth of a chunk in ascending k from 0, the
  eight added in order, the chunk sums in ascending K), is within
  ``bench.common.xv_tolerance`` of the plain version, and its rows are
  bitwise the same at every M, whichever regime and tiles the plan takes.

The kernel itself runs only on the card (``chip_smoke.py`` phase 2 holds the
plan to the source's, phase 3 the kernel to its plain version and its rows
across M)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.bench.common import xv_tolerance
from repro_torch.kernels import prologue
from repro_torch.kernels.hadamard import fwht_plain
from repro_torch.kernels.rowops import default_proj_tiles

# (M, K, R, rotate, x bytes, V bytes, SMs): Phi-3-mini's sites at decode
# and chunk M, phase 12's large M, ragged K (not a multiple of the chunk or
# of 8), R not a multiple of a column tile, R 0, f32 operands, few SMs
# (the tiled regime at small shapes, with and without a K split)
PLAN_CASES = [
    (4, 3072, 307, False, 2, 2, 132), (16, 8192, 307, False, 2, 2, 132),
    (100, 3072, 307, False, 2, 2, 132), (100, 8192, 922, False, 2, 2, 132),
    (2048, 8192, 922, True, 2, 2, 132), (256, 4096, 128, False, 2, 2, 132),
    (1, 90, 33, False, 4, 4, 132), (3, 5, 3, False, 2, 4, 132),
    (17, 200, 7, False, 2, 2, 132), (33, 8194, 5, False, 2, 2, 132),
    (130, 1030, 70, False, 2, 2, 4), (130, 1030, 70, False, 2, 2, 16),
    (65, 2048, 130, True, 4, 2, 8), (20, 256, 0, True, 2, 2, 132),
]


def _blocks(plan, m, k, r):
    """(rows, columns, sub-chunks) of every projection block the plan
    launches, as ranges clipped to M, R and the sub-chunks inside K."""
    sub = plan.bk // prologue.SUBS
    nsub = -(-k // sub)
    out = []
    for mt in range(plan.tiles_m):
        rows = range(mt * plan.rows, min((mt + 1) * plan.rows, m))
        for rt in range(plan.tiles_r):
            cols = range(rt * plan.cols, min((rt + 1) * plan.cols, r))
            for split in range(plan.splits):
                c0 = split * plan.chunks_per_split
                c1 = min(c0 + plan.chunks_per_split, plan.chunks)
                subs = range(c0 * prologue.SUBS, min(c1 * prologue.SUBS, nsub))
                out.append((rows, cols, subs, c0, c1))
    return out


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: "x".join(map(str, c)))
def test_plan_covers_every_chain_once(case):
    """Every (row, column, sub-chunk) of x·V in exactly one block; the
    plan a function of shapes and SMs alone, within a block's limits, its
    scratch holding the split partials and rotated rows it lays out."""
    m, k, r, rot, xb, vb, sms = case
    plan = prologue.prologue_plan(m, k, r, rot, xb, vb, sms)
    assert plan == prologue.prologue_plan(m, k, r, rot, xb, vb, sms)
    assert plan.bk == default_proj_tiles(k, 1)[0] and plan.chunks == -(-k // plan.bk)
    assert plan.tiled == (m > prologue.STREAM_M and k >= prologue.TILED_MIN_K
                          and -(-m // prologue.T_BM) * -(-r // prologue.T_BN) * plan.chunks
                          >= sms)
    if not plan.tiled:
        assert plan.chunks_per_split == 1 and plan.splits == plan.chunks
        assert plan.rows == (4 if m <= 4 else 8 if m <= prologue.STREAM_M else 16)
        lc16 = plan.rows == 4 and plan.chunks * -(-r // 32) < sms
        assert plan.cols == (64 if plan.rows == 16 else 16 if lc16 else 32)
    assert (plan.splits - 1) * plan.chunks_per_split < plan.chunks
    assert plan.splits * plan.chunks_per_split >= plan.chunks
    assert plan.threads <= 1024 and 0 < plan.smem_bytes <= 227 * 1024
    assert plan.launches == (2 if rot and r else 1)
    sub = plan.bk // prologue.SUBS
    nsub = -(-k // sub)
    seen = np.zeros((m, r, nsub), np.int32)
    for rows, cols, subs, _, _ in _blocks(plan, m, k, r):
        seen[rows.start:rows.stop, cols.start:cols.stop, subs.start:subs.stop] += 1
    assert (seen == 1).all()
    split = r > 0 and plan.splits > 1
    tiles = plan.tiles_m * plan.tiles_r
    assert plan.zeroed_bytes == (4 * tiles if split else 0)
    part = 4 * tiles * plan.chunks * plan.rows * plan.cols if split else 0
    assert plan.scratch_bytes == part + (4 * m * k if rot and r else 0)
    # more SMs never fewer blocks in the tiled regime
    more = prologue.prologue_plan(m, k, r, rot, xb, vb, 2 * sms)
    if plan.tiled and more.tiled:
        assert more.splits >= plan.splits


def test_scratch_is_cached_and_grows():
    """One zeroed and one plain buffer per (device, stream), reused while
    large enough and grown, zeroed, when a call needs more."""
    dev = torch.device("cpu")
    key = (dev.index, -1)
    prologue._SCRATCH.pop(key, None)
    z1, s1 = prologue._scratch(dev, -1, 64, 32)
    z2, s2 = prologue._scratch(dev, -1, 16, 8)
    assert (z1, s1) == (z2, s2)
    z3, s3 = prologue._scratch(dev, -1, 4096, 8)
    zeroed = prologue._SCRATCH[key][0]
    assert zeroed.numel() == 4096 and not zeroed.any() and z3 == zeroed.data_ptr()
    assert s3 == s1
    _, s4 = prologue._scratch(dev, -2, 0, 8)
    assert s4 != s1  # another stream, another buffer
    assert prologue._scratch(dev, -1, 0, 0) == (None, None)
    prologue._SCRATCH.pop(key)
    prologue._SCRATCH.pop((dev.index, -2))


def _launch_tickets(tickets, plan, rng):
    """One launch's tickets as the kernel takes them: each output tile's
    blocks (its K splits) arrive in a random order, each adds one to the
    tile's ticket and reads the old value; the one that reads total - 1 is
    the tile's last and resets the ticket.  Returns each tile's finishers."""
    tiles = plan.tiles_m * plan.tiles_r
    order = [t for t in range(tiles) for _ in range(plan.splits)]
    rng.shuffle(order)
    finishers = [0] * tiles
    for tile in order:
        old = tickets[tile]
        tickets[tile] += 1
        if old == plan.splits - 1:
            tickets[tile] = 0
            finishers[tile] += 1
    return finishers


def test_tickets_reset_themselves():
    """Two launches in a row on one zeroed buffer, of two shapes: every
    ticket is back at zero after each, one finishing block a tile."""
    rng = np.random.default_rng(0)
    plans = [prologue.prologue_plan(4, 8192, 922), prologue.prologue_plan(100, 8192, 922),
             prologue.prologue_plan(16, 3072, 307)]
    tickets = np.zeros(max(p.zeroed_bytes for p in plans) // 4, np.int64)
    for plan in plans + plans[::-1]:
        assert plan.zeroed_bytes and plan.splits > 1
        finishers = _launch_tickets(tickets, plan, rng)
        assert finishers == [1] * (plan.tiles_m * plan.tiles_r)
        assert not tickets.any()


def _fmaf(a, b, c):
    """fmaf on f32 arrays: the product exact in f64, the sum rounded to f32
    (a double rounding at worst, the same for every caller here)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def emulate_xv(x, v, plan):
    """The kernel's x·V, block by block as the plan launches them: in each
    block, each sub-chunk's chain of fmaf in ascending k from 0 (the
    stream regime runs the valid k, the tiled one the chunk padded with
    zeros, which adds nothing), the eight chains added in order into the
    chunk's sum, the chunk sums added in ascending K (by the block itself,
    or by the tile's last block where K is split)."""
    m, k = x.shape
    r = v.shape[1]
    bk, sub = plan.bk, plan.bk // prologue.SUBS
    xp = np.zeros((m, plan.chunks * bk), np.float32)
    xp[:, :k] = x
    vp = np.zeros((plan.chunks * bk, r), np.float32)
    vp[:k] = v
    partial = {}
    for rows, cols, _, c0, c1 in _blocks(plan, m, k, r):
        if not len(rows) or not len(cols):
            continue
        xs, vs = xp[rows.start:rows.stop], vp[:, cols.start:cols.stop]
        for c in range(c0, c1):
            chunk = None
            for w in range(prologue.SUBS):
                kb = c * bk + w * sub
                ke = min(kb + sub, k) if not plan.tiled else kb + sub
                acc = np.zeros((len(rows), len(cols)), np.float32)
                for kk in range(kb, ke):
                    acc = _fmaf(xs[:, kk:kk + 1], vs[kk:kk + 1], acc)
                chunk = acc if w == 0 else (chunk + acc).astype(np.float32)
            partial[(rows.start, cols.start, c)] = (rows, cols, chunk)
    out = np.full((m, r), np.nan, np.float32)
    for (r0, q0, c), (rows, cols, chunk) in sorted(partial.items()):
        if c == 0:
            out[rows.start:rows.stop, cols.start:cols.stop] = chunk
        else:
            out[rows.start:rows.stop, cols.start:cols.stop] = (
                out[rows.start:rows.stop, cols.start:cols.stop] + chunk).astype(np.float32)
    return out


# (K, R, rotate): a whole number of chunks, a ragged last chunk (K % 8 != 0),
# the rotated rows (K a power of two)
ORDER_CASES = [(1024, 70, False), (1030, 37, False), (512, 40, True)]
# M of the calls whose rows must agree (an H100's 132 SMs: the stream
# regime's 4-, 8- and 16-row tiles), then M 130 on as many SMs as it has
# output tiles (the register tiles over all of K) and as (tile, chunk) pairs
# (the register tiles with K split)
ORDER_MS = (1, 4, 16, 40)
TILED_M = 130


def _order_calls(k, r, rot):
    tiles = -(-TILED_M // prologue.T_BM) * -(-r // prologue.T_BN)
    chunks = prologue.prologue_plan(TILED_M, k, r, rot).chunks
    calls = [(m, 132) for m in ORDER_MS] + [(TILED_M, tiles)]
    return calls + ([(TILED_M, tiles * chunks)] if chunks > 1 else [])


@pytest.mark.parametrize("k,r,rot", ORDER_CASES)
def test_xv_order_within_tolerance_and_bitwise_across_m(k, r, rot):
    rng = np.random.default_rng(k + r)
    calls = _order_calls(k, r, rot)
    mmax = max(m for m, _ in calls)
    x = rng.standard_normal((mmax, k)).astype(np.float32)
    v = torch.from_numpy(rng.standard_normal((k, r)).astype(np.float32) * 0.05).to(
        torch.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    rows = fwht_plain(xt.float()) if rot else xt.float()
    vf = v.float().numpy()
    whole = None
    regimes = set()
    for m, sms in sorted(calls, key=lambda c: (-c[0], c[1])):
        plan = prologue.prologue_plan(m, k, r, rot, 2, 2, sms)
        regimes.add((plan.tiled, plan.rows, plan.splits > 1))
        xv = emulate_xv(rows[:m].numpy(), vf, plan)
        if whole is None:
            whole = xv
            _, _, xv_plain = prologue.fused_prologue_plain(xt[:m], v, 4, 0.9, rot)
            tol = xv_tolerance(rows[:m], v, k, xv_plain).numpy()
            assert np.all(np.abs(xv - xv_plain.numpy()) <= tol)
        else:
            assert np.array_equal(xv.view(np.int32), whole[:m].view(np.int32)), (m, sms)
    # M 1 and 4 share a plan; every other call takes its own: the stream's
    # three row tiles, the tiles over all of K and, where K has chunks to
    # split, the tiles with K split
    assert len(regimes) == len(calls) - 1
    assert {(t, split) for t, _, split in regimes if t} == (
        {(1, False), (1, True)} if len(calls) > 5 else {(1, False)})

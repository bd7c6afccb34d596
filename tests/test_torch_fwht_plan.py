"""The Walsh-Hadamard transform kernel's plan and its order (#5,
``csrc/fwht.cu``), on the CPU:

* ``hadamard.fwht_plan`` applies each sweep h = 1, 2, ... D/2 exactly once
  and in ascending order, at every power of two up to ``MAX_D``, with at
  most two exchanges through shared memory a row, each sweep in registers
  or across lanes at a place its layout has;
* a numpy f32 emulation of that schedule (the units each thread loads, its
  register sweeps, the lane sweeps with the lower lane computing a + b and
  the upper o + (-v), the exchange through the swizzled shared memory, the
  multiply and the stores) is bitwise ``fwht_plain`` and the JAX
  reference's ``rowops.fwht_rows``, f32 and bf16 rows;
* the swizzle leaves the exchange's 16-byte accesses free of bank
  conflicts, as the source says.

The kernel itself runs only on the card (``chip_smoke.py`` phase 2 holds the
plan to the source's, phase 3 the kernel to its plain version and its rows
across M)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import rowops as jrowops
from repro_torch.kernels import hadamard

WIDTHS = [2 ** e for e in range(16)]


def _bits(plan, x_bytes):
    n = 16 // x_bytes
    return n, n.bit_length() - 1, plan.chunks.bit_length() - 1


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("x_bytes", [2, 4])
def test_plan_sweeps_each_h_once_ascending(d, x_bytes):
    plan = hadamard.fwht_plan(d, x_bytes)
    n, nb, cb = _bits(plan, x_bytes)
    assert [s[0] for s in plan.steps] == [2 ** b for b in range(d.bit_length() - 1)]
    assert plan.exchanges <= 2
    assert [s[1] for s in plan.steps] == sorted(s[1] for s in plan.steps)
    assert max((s[1] for s in plan.steps), default=0) == plan.exchanges
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    assert plan.rows_per_block * d == plan.threads * plan.chunks * n
    assert plan.smem_bytes == (4 * plan.threads * plan.chunks * n if plan.exchanges else 0)
    assert plan.smem_bytes <= 227 * 1024
    for stage in range(plan.exchanges + 1):
        places = [(kind, pos) for (_, st, kind, pos) in plan.steps if st == stage]
        assert len(set(places)) == len(places)  # one sweep a place in a layout
        for kind, pos in places:
            assert pos < (nb + cb if kind == 0 else 5)
    assert plan == hadamard.fwht_plan(d, x_bytes)


def _slot(n, q, j):
    """The source's float4 slot of half j of unit q (``slot<N>``)."""
    return 2 * q + (j ^ (((q >> 2) ^ (q >> 9)) & 1)) if n == 8 else q


def _layouts(plan, n):
    """Unit index q[t, k] in the tile of each thread's register unit k,
    before and (where there is one) after the exchange."""
    t = np.arange(plan.threads)[:, None]
    k = np.arange(plan.chunks)[None, :]
    lane, warp = t % 32, t // 32
    cb = plan.chunks.bit_length() - 1
    before = lane + 32 * (k + plan.chunks * warp)
    if not plan.exchanges:
        return before, None
    hr = sum(1 for s in plan.steps if s[1] == 1 and s[2] == 0)
    hl = sum(1 for s in plan.steps if s[1] == 1 and s[2] == 1)
    omega = hr + hl
    pl = 5 - hl
    wp, wq, rest = warp & ((1 << hl) - 1), (warp >> hl) & ((1 << hr) - 1), warp >> (hl + hr)
    p = (lane & ((1 << pl) - 1)) | wp << pl
    h = (k & ((1 << hr) - 1)) | (lane >> pl) << hr
    q = (k >> hr) | wq << (cb - hr)
    after = p | q << 5 | h << (5 + cb) | rest << (5 + cb + omega)
    return before, after


def _emulate(x32, plan, x_bytes):
    """The kernel's schedule on the rows x32 (M, D) in numpy f32."""
    m, d = x32.shape
    n = 16 // x_bytes
    v_len = plan.chunks * n
    tile = plan.threads * v_len
    blocks = -(-m // plan.rows_per_block)
    flat = np.zeros(blocks * tile, dtype=np.float32)
    flat[:m * d] = x32.ravel()
    out = np.zeros_like(flat)
    before, after = _layouts(plan, n)
    lanes = np.arange(plan.threads) % 32
    e = np.arange(n)
    nrm = np.float32(1.0 / d ** 0.5)
    for b in range(blocks):
        vals = flat[b * tile:(b + 1) * tile]
        regs = vals[(n * before)[:, :, None] + e].reshape(plan.threads, v_len)
        q_now = before
        for (_, stage, kind, pos) in plan.steps:
            if stage == 1 and q_now is before:  # the exchange
                smem = np.full((tile // 4, 4), np.nan, dtype=np.float32)
                for k in range(plan.chunks):
                    for j in range(n // 4):
                        slots = _slot(n, before[:, k], j)
                        assert np.isnan(smem[slots]).all()  # each slot written once
                        smem[slots] = regs[:, k * n + 4 * j:k * n + 4 * j + 4]
                for k in range(plan.chunks):
                    for j in range(n // 4):
                        regs[:, k * n + 4 * j:k * n + 4 * j + 4] = smem[_slot(n, after[:, k], j)]
                q_now = after
            if kind == 0:
                g = 1 << pos
                lo = [j for j in range(v_len) if not j & g]
                hi = [j + g for j in lo]
                a, c = regs[:, lo].copy(), regs[:, hi].copy()
                regs[:, lo], regs[:, hi] = a + c, a - c
            else:
                mask = 1 << pos
                o = regs[np.arange(plan.threads) ^ mask]
                upper = (lanes & mask).astype(bool)[:, None]
                regs = np.where(upper, o + (-regs), regs + o)
        regs = regs * nrm
        idx = (n * q_now)[:, :, None] + e
        out[b * tile + idx.reshape(plan.threads, v_len)] = regs
    return out[:m * d].reshape(m, d)


@pytest.mark.parametrize("m,d", [(5, 2), (13, 512), (4, 8192), (3, 32768), (9, 1024), (3, 2048)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_emulated_schedule_bitwise_plain_and_reference(m, d, dtype):
    rng = np.random.default_rng(m * d)
    x = (rng.standard_normal((m, d)) * 3).astype(np.float32)
    xt = torch.from_numpy(x)
    if dtype == "bf16":
        xt = xt.to(torch.bfloat16)
    x32 = xt.float().numpy()
    plan = hadamard.fwht_plan(d, xt.element_size())
    got = torch.from_numpy(_emulate(x32, plan, xt.element_size())).to(xt.dtype)
    want = hadamard.fwht_plain(xt)
    assert torch.equal(got, want)
    ref = torch.from_numpy(np.array(jrowops.fwht_rows(jnp.asarray(x32), d))).to(xt.dtype)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("d", [2048, 4096, 8192, 16384, 32768])
@pytest.mark.parametrize("x_bytes", [2, 4])
def test_exchange_has_no_bank_conflicts(d, x_bytes):
    """Every 8-lane phase of a warp's 16-byte store (before) and load
    (after) touches 8 distinct 16-byte bank groups."""
    plan = hadamard.fwht_plan(d, x_bytes)
    n = 16 // x_bytes
    before, after = _layouts(plan, n)
    for q in (before, after):
        for k in range(plan.chunks):
            for j in range(n // 4):
                slots = _slot(n, q[:, k], j).reshape(-1, 8) % 8
                assert all(len(set(row)) == 8 for row in slots)

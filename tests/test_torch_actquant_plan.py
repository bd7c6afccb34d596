"""The activation quantizer kernel's launch plan and its order (#4,
``csrc/act_quant.cu``), on the CPU:

* ``actquant.act_quant_plan`` depends on (K, g, x's width, alignment)
  alone: only the row and block counts follow M;
* the threads it launches hold every unit of every row, and so every
  (row, group), exactly once, in the held body and in the staged one, within
  a block's limits;
* a numpy walk of the plan (each thread's units, its partial amax, the
  lanes' xor tree, the warps' maxima in order, then the scale and the codes
  from the held values) gives codes and scales bitwise the plain version's
  and the JAX reference's ``rowops.scale_round_quantize``, per token and per
  group, f32 and bf16 rows, the 16-byte and the element-wise readers.

The kernel itself runs only on the card (``chip_smoke.py`` phase 2 holds the
plan to the source's, phase 3 the kernel to its plain version and its rows
across M)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import rowops as jrowops
from repro_torch.kernels import actquant

KS = (576, 3072, 8192, 8194, 16384, 24576)
GROUPS = (None, 64, 128)
MS = (1, 4, 16, 17, 2048)
PLAN_CASES = [(k, g, xb) for k in KS for g in GROUPS if g is None or k % g == 0
              for xb in (2, 4)]


def _walk(plan):
    """(row, unit) of every unit every launched thread holds, as two arrays."""
    threads = np.arange(plan.threads)
    blocks = np.arange(plan.blocks)
    if plan.staged:
        js = np.arange(-(-plan.units // plan.threads))
        row = np.broadcast_to(blocks[:, None, None], (plan.blocks, plan.threads, len(js)))
        unit = np.broadcast_to(threads[None, :, None] + plan.threads * js[None, None, :],
                               row.shape)
    else:
        js = np.arange(plan.chunks)
        row = (blocks[:, None, None] * plan.rows_per_block
               + (threads // plan.tpr)[None, :, None]) + 0 * js
        unit = np.broadcast_to((threads % plan.tpr)[None, :, None] + plan.tpr * js[None, None, :],
                               row.shape)
    row, unit = row.ravel(), unit.ravel()
    keep = (row < plan.rows) & (unit < plan.units)
    return row[keep], unit[keep]


@pytest.mark.parametrize("k,g,xb", PLAN_CASES, ids=lambda v: str(v))
def test_plan_covers_every_unit_once(k, g, xb):
    """Every unit of every row (per token) or of every (row, group) is held
    by exactly one thread, at every M; the plan's per-row fields do not
    depend on M."""
    n = 16 // xb
    for aligned in (True, False):
        plans = {m: actquant.act_quant_plan(m, k, g, xb, aligned) for m in MS}
        first = plans[MS[0]]
        for m, plan in plans.items():
            assert plan._replace(rows=0, blocks=0) == first._replace(rows=0, blocks=0)
            assert plan.rows == (m * (k // g) if g else m)
            assert plan.width == (g or k)
            assert plan.vec == int(aligned and plan.width % n == 0)
            assert plan.units * (n if plan.vec else 1) == plan.width
            assert plan.threads <= actquant.MAX_THREADS and plan.threads % 32 == 0
            assert plan.smem_bytes <= 227 * 1024
            assert plan.tpr & (plan.tpr - 1) == 0 and plan.threads % plan.tpr == 0
            if plan.staged:
                assert plan.width > actquant.WARP_MAX_K and plan.rows_per_block == 1
            else:
                assert plan.chunks >= plan.loads and plan.chunks * plan.tpr >= plan.units
                if plan.width > actquant.WARP_MAX_K:  # a block a row
                    assert plan.rows_per_block == 1 and plan.tpr == plan.threads
                    assert plan.chunks * (4 if plan.vec else 1) <= actquant.HELD_REGS
                else:
                    assert plan.tpr <= 32
            if not aligned and m > 17:
                continue  # the element-wise reader's walk is large; M <= 17 covers it
            row, unit = _walk(plan)
            counts = np.bincount(row * plan.units + unit, minlength=plan.rows * plan.units)
            assert counts.shape == (plan.rows * plan.units,) and (counts == 1).all()


def test_group_plan_takes_a_16_byte_load_a_lane():
    """bf16 groups of 128 and 64 are 16 and 8 lanes a group, one 16-byte load
    each; several groups a warp."""
    for g, lanes in ((128, 16), (64, 8)):
        p = actquant.act_quant_plan(4, 3072, g, 2)
        assert (p.vec, p.tpr, p.loads, p.chunks) == (1, lanes, 1, 1)
        assert p.rows_per_block == p.threads // lanes > 1


def _emulate(x32, plan, m, k, g, bits, clip):
    """The kernel's walk of the plan in numpy f32: codes (M, K) int8 and the
    scales (M, 1) or (M, K/g)."""
    qmax = 2 ** (bits - 1) - 1
    n = plan.width // plan.units
    rows = x32.reshape(plan.rows, plan.units, n)
    codes = np.empty((plan.rows, plan.units, n), dtype=np.int8)
    scales = np.empty(plan.rows, dtype=np.float32)
    lo, hi = np.float32(-qmax - 1), np.float32(qmax)
    tpr = plan.threads if plan.staged else plan.tpr
    held = -(-plan.units // tpr)
    for r in range(plan.rows):
        # each thread's partial amax over its units t, t + tpr, ... in order
        part = np.zeros(tpr, dtype=np.float32)
        for t in range(tpr):
            for j in range(held):
                i = t + j * tpr
                if i < plan.units:
                    for e in range(n):
                        part[t] = max(part[t], abs(rows[r, i, e]))
        # the lanes' xor tree, then the warps' maxima in order
        off = min(tpr, 32) // 2
        while off:
            part = np.maximum(part, part[np.arange(tpr) ^ off])
            off //= 2
        a = part[0]
        for w in range(1, tpr // 32):
            a = max(a, part[32 * w])
        a = np.float32(1.0) if a <= 0 else np.float32(a)
        s = np.float32(np.float32(clip) * a) / np.float32(qmax)
        scales[r] = s
        codes[r] = np.clip(np.rint(rows[r] / s), lo, hi).astype(np.int8)
    return codes.reshape(m, k), scales.reshape(m, -1)


EMU_CASES = [(4, 576, None), (3, 3072, None), (2, 8192, None), (3, 8194, None),
             (2, 16384, None), (1, 24576, None), (4, 3072, 128), (3, 576, 64), (17, 200, 8),
             (4, 200, 10), (5, 90, 45), (2, 3072, 3072), (1, 40000, None)]


@pytest.mark.parametrize("m,k,g", EMU_CASES, ids=lambda v: str(v))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_emulated_walk_bitwise_plain_and_reference(m, k, g, dtype):
    rng = np.random.default_rng(m * k + (g or 0))
    x = (rng.standard_normal((m, k)) * 2).astype(np.float32)
    x[m // 2] = 0.0  # an all-zero row (or groups) takes the guarded scale
    xt = torch.from_numpy(x)
    if dtype == "bf16":
        xt = xt.to(torch.bfloat16)
    x32 = xt.float().numpy()
    q_p, s_p = actquant.act_quant_plain(xt, 4, 0.9, g)
    q_j, s_j = jrowops.scale_round_quantize(jnp.asarray(x32), 7, 0.9, g)
    assert np.array_equal(q_p.numpy(), np.asarray(q_j))
    assert np.array_equal(s_p.numpy(), np.asarray(s_j))
    xb = xt.element_size()
    for aligned in (True, False):
        if not aligned and k > 9000:
            continue  # the element-wise walk at this width is slow; 8194 covers it
        plan = actquant.act_quant_plan(m, k, g, xb, aligned)
        codes, scales = _emulate(x32, plan, m, k, g, 4, 0.9)
        assert np.array_equal(codes, q_p.numpy()), (aligned, plan)
        assert np.array_equal(scales, s_p.numpy()), (aligned, plan)


def test_wrapper_refuses_rows_wider_than_max_k():
    """A CUDA-side limit the plan states: a row (K, or g) of at most MAX_K
    values; the CPU path has none."""
    assert actquant.act_quant_plan(1, actquant.MAX_K, None, 4).staged == 1
    assert actquant.act_quant_plan(1, actquant.MAX_K, None, 4).smem_bytes <= 227 * 1024

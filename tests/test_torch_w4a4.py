"""The W4A4 low-rank GEMM's plain version against the reference.

On the CPU the wrapper runs the plain version; the CUDA kernel is held
against that plain version on the card by ``chip_smoke.py``.

Tolerances: the int32 GEMM and its rescale ``acc·sx·sw`` are exact and
bitwise; only the R-term LR sum ``xv·Uᵀ`` is added up in another order
(MKL here, XLA there), so each element is held to twice the f32
recursive-summation bound of that sum (``torch_parity.gemm_tolerance``).
The Pallas kernel itself is compared through the chained and unfused paths
in ``test_torch_paths``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import w4a4
from repro_torch.kernels.rowops import int_matmul, unpack_int4_rows
from torch_parity import gemm_tolerance, port, t, w4a4_problem

# Phi-3-mini's three site shapes, the paper's 30 % rank, then ragged ones:
# odd N, K % 4 == 2, K = 16384, rank 0
SHAPES = [(3072, 3072, 307), (3072, 8192, 307), (8192, 3072, 307),
          (3072, 3072, 922), (200, 97, 7), (8194, 33, 5), (16384, 16, 40),
          (90, 33, 0)]


def _inputs(m, k, n, r):
    """The GEMM's operands as the prologue makes them: codes and scales of
    random rows, and xv = x·V in f32."""
    x, wp, sw, u, v = w4a4_problem(k * 7 + n + r, m, k, n, r)
    xq, sx = jref.act_quant_ref(jnp.asarray(x), bits=4, clip_ratio=0.9)
    xv = None if v is None else x @ v.astype(np.float32)
    return np.asarray(xq), np.asarray(sx), wp, sw, xv, u


@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("k,n,r", SHAPES)
def test_plain_matches_reference(m, k, n, r):
    xq, sx, wp, sw, xv, u = _inputs(m, k, n, r)
    before = dict(w4a4.LAUNCHES)
    got = w4a4.w4a4_lowrank_matmul(t(xq), t(sx), t(wp), t(sw), port(xv), port(u))
    # on the CPU the wrapper runs the plain version, never the kernel
    assert (w4a4.LAUNCHES["w4a4_lowrank_matmul_plain"]
            == before["w4a4_lowrank_matmul_plain"] + 1)
    assert w4a4.LAUNCHES["w4a4_lowrank_matmul"] == before["w4a4_lowrank_matmul"]
    assert got.dtype == torch.float32 and got.shape == (m, n)
    want = np.asarray(jref.w4a4_lowrank_matmul_ref(
        jnp.asarray(xq), jnp.asarray(sx), jnp.asarray(wp),
        jnp.asarray(sw).reshape(1, -1), None if xv is None else jnp.asarray(xv),
        None if u is None else jnp.asarray(u)))
    uf = None if u is None else u.astype(np.float32)
    assert np.all(np.abs(got.numpy() - want) <= gemm_tolerance(xv, uf, r, want))
    # the integer GEMM and its rescale alone are bitwise
    acc = int_matmul(t(xq), unpack_int4_rows(t(wp)))
    no_lr = np.asarray(jref.w4a4_lowrank_matmul_ref(
        jnp.asarray(xq), jnp.asarray(sx), jnp.asarray(wp),
        jnp.asarray(sw).reshape(1, -1)))
    assert np.array_equal((acc.float() * t(sx) * t(sw)).numpy(), no_lr)


def test_operand_checks():
    xq, sx, wp, sw, xv, u = _inputs(2, 64, 8, 4)
    with pytest.raises(ValueError):  # xv without u
        w4a4._check(t(xq), t(sx), t(wp), t(sw), t(xv), None)
    with pytest.raises(TypeError):  # codes must be int8
        w4a4._check(t(xq).float(), t(sx), t(wp), t(sw), None, None)
    with pytest.raises(ValueError):  # W must hold K/2 packed rows
        w4a4._check(t(xq), t(sx), t(wp[:-1]), t(sw), None, None)


def test_reset_launches():
    w4a4.LAUNCHES["w4a4_lowrank_matmul_plain"] += 3
    w4a4.reset_launches()
    assert w4a4.LAUNCHES == {"w4a4_lowrank_matmul": 0,
                             "w4a4_lowrank_matmul_plain": 0}

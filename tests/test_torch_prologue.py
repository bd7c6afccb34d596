"""The fused prologue's plain version against the reference.

On the CPU the wrapper runs the plain version; the CUDA kernel is held
against that plain version on the card by ``chip_smoke.py``.

Tolerances: codes and scales are bitwise.  x·V is summed in the
reference's K-chunked order (``project_rows_tiled``), but each chunk's dot
is added up by MKL here and by XLA there, so each element is held to twice
the f32 recursive-summation bound of its K-term sum
(``torch_parity.xv_tolerance``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import rowops as jrowops
from repro_torch.kernels import prologue
from repro_torch.kernels.rowops import default_proj_tiles
from torch_parity import scales_match_jitted, port, run_pallas, t, w4a4_problem, xv_tolerance

# Phi-3-mini's two K at its rank, the paper's 30 % rank, then ragged ones:
# K not a power of two (K % 4 == 2), rank 1 and 0, K below one chunk
SHAPES = [(3072, 307), (8192, 307), (3072, 922), (8194, 5), (200, 7),
          (90, 1), (64, 0)]


@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("k,r", SHAPES)
def test_plain_matches_reference(m, k, r):
    x, _, _, _, v = w4a4_problem(k + r, m, k, 8, r)
    before = dict(prologue.LAUNCHES)
    xq, sx, xv = prologue.fused_prologue(t(x), port(v), bits=4, clip_ratio=0.9)
    # on the CPU the wrapper runs the plain version, never the kernel
    assert prologue.LAUNCHES["fused_prologue_plain"] == before["fused_prologue_plain"] + 1
    assert prologue.LAUNCHES["fused_prologue"] == before["fused_prologue"]
    q_j, s_j, xv_j = jref.fused_prologue_ref(
        jnp.asarray(x), None if v is None else jnp.asarray(v), bits=4,
        clip_ratio=0.9)
    assert np.array_equal(xq.numpy(), np.asarray(q_j))
    assert np.array_equal(sx.numpy(), np.asarray(s_j))
    if not r:
        assert xv is None
        return
    vf = v.astype(np.float32)
    assert xv.shape == (m, r) and xv.is_contiguous()
    assert np.all(np.abs(xv.numpy() - np.asarray(xv_j)) <= xv_tolerance(x, vf, k, xv_j))
    # the tiled rowops body the kernels share, at the default tiles
    bk, br = default_proj_tiles(k, r)
    kp, rp = k + (-k) % bk, r + (-r) % br
    tiled = np.asarray(jrowops.project_rows_tiled(
        jnp.pad(jnp.asarray(x), ((0, 0), (0, kp - k))),
        jnp.pad(jnp.asarray(vf), ((0, kp - k), (0, rp - r))), bk, br))[:, :r]
    assert np.all(np.abs(xv.numpy() - tiled) <= xv_tolerance(x, vf, k, tiled))


def test_reset_launches():
    prologue.LAUNCHES["fused_prologue_plain"] += 3
    prologue.reset_launches()
    assert prologue.LAUNCHES == {"fused_prologue": 0, "fused_prologue_plain": 0}


@pytest.mark.parametrize("k,r", [(576, 19), (200, 7)])
def test_plain_matches_pallas_kernel_in_interpret_mode(tmp_path, k, r):
    """``fused_prologue_kernel`` itself, in interpret mode (rows padded to
    its 8-row tile with zeros and cut back); its scales are jitted
    (``torch_parity.scales_match_jitted``)."""
    x, _, _, _, v = w4a4_problem(k, 5, k, 8, r)
    got = run_pallas(tmp_path, """
from repro.kernels.prologue import fused_prologue_kernel
x = np.pad(d["x"], ((0, 3), (0, 0)))
q, s, xv = fused_prologue_kernel(jnp.asarray(x), jnp.asarray(d["v"]), bits=4,
                                 clip_ratio=0.9, bm=8)
out["q"], out["s"], out["xv"] = (np.asarray(a)[:5] for a in (q, s, xv))
""", x=x, v=v)
    xq, sx, xv = prologue.fused_prologue(t(x), port(v), bits=4, clip_ratio=0.9)
    assert np.array_equal(xq.numpy(), got["q"])  # no code flips on these inputs
    assert scales_match_jitted(sx.numpy(), got["s"])
    tol = xv_tolerance(x, v.astype(np.float32), k, got["xv"])
    assert np.all(np.abs(xv.numpy() - got["xv"]) <= tol)

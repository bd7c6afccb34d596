"""The fused W4A4+LRC kernel's plain version against the reference.

On the CPU the wrapper runs the plain version; the CUDA kernel is held
against that plain version on the card by ``chip_smoke.py``.

Tolerances: the prologue's codes and scales, and the int32 GEMM, are
bitwise.  The output differs from the reference only in the order of the
two LR sums (K terms of x·V, R terms of xv·Uᵀ — MKL and XLA add them in
different orders), so each element is held to twice the f32
recursive-summation bound of those sums (``torch_parity.lr_tolerance``)."""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.core.quantizers import QuantSpec, pack_int4
from repro_torch.kernels import fused_gemm, ops
from repro_torch.kernels.rowops import scale_round_quantize
from torch_parity import lr_tolerance, t

ROOT = Path(__file__).resolve().parents[1]

# SmolLM-135M's four distinct site shapes (K, N, R), then the ragged ones:
# odd N, K not a multiple of 64 (and K % 4 == 2), rank 0
SHAPES = [(576, 576, 58), (576, 192, 19), (576, 1536, 58), (1536, 576, 58),
          (200, 97, 7), (90, 33, 0), (576, 577, 58), (64, 48, 0)]


def _problem(seed, m, k, n, r):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 2).astype(np.float32)
    q = rng.integers(-8, 8, (k, n)).astype(np.int8)
    wp = pack_int4(t(q).T).T.contiguous().numpy()
    sw = (rng.random(n) * 0.02 + 0.001).astype(np.float32)
    u = v = None
    if r:
        bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))  # noqa: E731
        u = bf(rng.standard_normal((n, r)) * 0.05)
        v = bf(rng.standard_normal((k, r)) * 0.05)
    return x, wp, sw, u, v


def _port(a):
    if a is None:
        return None
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return t(a)


@functools.lru_cache(maxsize=None)
def _reference(k, n, r):
    """One 16-row problem per shape and the reference's output for it; the
    M = 1 and M = 4 cases take its leading rows (every row is quantized and
    multiplied on its own), so the reference compiles once per shape."""
    x, wp, sw, u, v = _problem(k + n + r, 16, k, n, r)
    want = np.asarray(jref.w4a4_lrc_forward_ref(
        jnp.asarray(x), jnp.asarray(wp), jnp.asarray(sw),
        None if u is None else jnp.asarray(u),
        None if v is None else jnp.asarray(v), bits=4, clip_ratio=0.9))
    xq, sx = jref.act_quant_ref(jnp.asarray(x), bits=4, clip_ratio=0.9)
    return (x, wp, sw, u, v), want, (np.asarray(xq), np.asarray(sx))


@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("k,n,r", SHAPES)
def test_plain_matches_reference(m, k, n, r):
    (x, wp, sw, u, v), want, (xq_j, sx_j) = _reference(k, n, r)
    x, want = x[:m], want[:m]
    before = dict(fused_gemm.LAUNCHES)
    got = fused_gemm.fused_w4a4_lrc(t(x), _port(v), t(wp), t(sw), _port(u),
                                    bits=4, clip_ratio=0.9)
    # on the CPU the wrapper runs the plain version, never the kernel
    assert fused_gemm.LAUNCHES["fused_w4a4_lrc_plain"] == before["fused_w4a4_lrc_plain"] + 1
    assert fused_gemm.LAUNCHES["fused_w4a4_lrc"] == before["fused_w4a4_lrc"]
    assert got.dtype == torch.float32 and got.shape == (m, n)
    uf = None if u is None else u.astype(np.float32)
    vf = None if v is None else v.astype(np.float32)
    tol = lr_tolerance(x, vf, uf, k, r, want)
    assert np.all(np.abs(got.numpy() - want) <= tol)

    # the prologue the plain version runs is bitwise the reference's
    xq_t, sx_t = scale_round_quantize(t(x), 7, 0.9)
    assert np.array_equal(xq_t.numpy(), xq_j[:m])
    assert np.array_equal(sx_t.numpy(), sx_j[:m])


def test_ops_dispatch_and_unported_options():
    x, wp, sw, u, v = _problem(3, 4, 64, 48, 8)
    spec = QuantSpec(bits=4, clip_ratio=0.9)
    y = ops.w4a4_lrc_forward(t(x), t(wp), t(sw), _port(u), _port(v), spec)
    y0 = fused_gemm.fused_w4a4_lrc_plain(t(x), _port(v), t(wp), t(sw),
                                         _port(u), 4, 0.9)
    assert torch.equal(y, y0)
    # the online rotation is ported: the fused kernel's plain version with
    # its rotate branch, which differs from the unrotated forward
    yr = ops.w4a4_lrc_forward(t(x), t(wp), t(sw), _port(u), _port(v), spec, rotate=True)
    assert torch.equal(yr, fused_gemm.fused_w4a4_lrc_plain(
        t(x), _port(v), t(wp), t(sw), _port(u), 4, 0.9, rotate=True))
    assert not torch.equal(yr, y0)
    # grouped activation scales are ported: the fused kernel's plain version
    # with its group branch, which differs from the per-token forward
    yg = ops.w4a4_lrc_forward(t(x), t(wp), t(sw), None, None, QuantSpec(group_size=16))
    assert torch.equal(yg, fused_gemm.fused_w4a4_lrc_plain(
        t(x), None, t(wp), t(sw), None, 4, 1.0, group=16))
    assert not torch.equal(yg, ops.w4a4_lrc_forward(t(x), t(wp), t(sw), None, None,
                                                    QuantSpec()))
    # the chained path is ported now: on the CPU it is bitwise the fused one
    yc = ops.w4a4_lrc_forward(t(x), t(wp), t(sw), _port(u), _port(v), spec,
                              impl="chained")
    assert torch.equal(yc, y0)


def test_reset_launches():
    fused_gemm.LAUNCHES["fused_w4a4_lrc_plain"] += 3
    fused_gemm.reset_launches()
    assert fused_gemm.LAUNCHES == {"fused_w4a4_lrc": 0, "fused_w4a4_lrc_plain": 0}


_PALLAS = r"""
import sys
import numpy as np
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
pltpu.TPUCompilerParams = pltpu.CompilerParams  # jax 0.9 renamed it
from repro.core.quantizers import QuantSpec
from repro.kernels import ops
d = np.load(sys.argv[1])
y = ops.w4a4_lrc_forward(jnp.asarray(d["x"]), jnp.asarray(d["wp"]),
                         jnp.asarray(d["sw"]), jnp.asarray(d["u"], jnp.bfloat16),
                         jnp.asarray(d["v"], jnp.bfloat16),
                         QuantSpec(bits=4, clip_ratio=0.9), impl="fused")
np.save(sys.argv[2], np.asarray(y))
"""


def test_plain_matches_pallas_kernel_in_interpret_mode(tmp_path):
    """The Pallas kernel itself, in interpret mode.  The jax installed here
    names the compiler params ``CompilerParams``; the alias is set in a
    subprocess so it never reaches another test's process."""
    m, k, n, r = 4, 576, 192, 19
    x, wp, sw, u, v = _problem(11, m, k, n, r)
    # bf16 factors travel as f32 (exact) and are cast back on the other side
    np.savez(tmp_path / "in.npz", x=x, wp=wp, sw=sw, u=u.astype(np.float32),
             v=v.astype(np.float32))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    subprocess.run([sys.executable, "-c", _PALLAS, str(tmp_path / "in.npz"),
                    str(tmp_path / "out.npy")], check=True, env=env,
                   timeout=600)
    want = np.load(tmp_path / "out.npy")
    got = fused_gemm.fused_w4a4_lrc(t(x), _port(v), t(wp), t(sw), _port(u),
                                    bits=4, clip_ratio=0.9).numpy()
    tol = lr_tolerance(x, v.astype(np.float32), u.astype(np.float32), k, r, want)
    assert np.all(np.abs(got - want) <= tol), json.dumps(
        float(np.abs(got - want).max()))

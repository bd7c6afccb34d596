"""The per-token quantizer's plain version against the reference.

On the CPU the wrapper runs the plain version; the CUDA kernel is held
against that plain version on the card by ``chip_smoke.py``.  Codes and
scales are integers and one rounded division each, so every comparison
here is bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import rowops as jrowops
from repro_torch.kernels import actquant, prologue
from torch_parity import scales_match_jitted, bf16, port, run_pallas, t

SHAPES = [(1, 3072), (4, 3072), (16, 8192), (5, 200), (3, 90), (17, 8194)]


def _x(seed, m, k):
    x = (np.random.default_rng(seed).standard_normal((m, k)) * 2).astype(np.float32)
    x[m // 2] = 0.0  # an all-zero row takes the guarded scale
    return x


@pytest.mark.parametrize("bits,clip", [(4, 0.9), (4, 1.0), (8, 0.9)])
@pytest.mark.parametrize("m,k", SHAPES)
def test_plain_matches_reference(m, k, bits, clip):
    x = _x(m * k, m, k)
    before = dict(actquant.LAUNCHES)
    xq, sx = actquant.act_quant(t(x), bits=bits, clip_ratio=clip)
    # on the CPU the wrapper runs the plain version, never the kernel
    assert actquant.LAUNCHES["act_quant_plain"] == before["act_quant_plain"] + 1
    assert actquant.LAUNCHES["act_quant"] == before["act_quant"]
    assert xq.dtype == torch.int8 and sx.shape == (m, 1)
    q_j, s_j = jref.act_quant_ref(jnp.asarray(x), bits=bits, clip_ratio=clip)
    assert np.array_equal(xq.numpy(), np.asarray(q_j))
    assert np.array_equal(sx.numpy(), np.asarray(s_j))
    # the rowops body the Pallas kernel runs
    q_r, s_r = jrowops.scale_round_quantize(jnp.asarray(x), 2 ** (bits - 1) - 1, clip)
    assert np.array_equal(xq.numpy(), np.asarray(q_r))
    assert np.array_equal(sx.numpy(), np.asarray(s_r))


def test_bf16_input_and_prologue_codes_agree():
    """bf16 rows quantize as their exact f32 values; the prologue's codes
    and scales are the quantizer's, bitwise."""
    x = bf16(_x(1, 6, 3072))
    xq, sx = actquant.act_quant(port(x), bits=4, clip_ratio=0.9)
    q_j, s_j = jref.act_quant_ref(jnp.asarray(x), bits=4, clip_ratio=0.9)
    assert np.array_equal(xq.numpy(), np.asarray(q_j))
    assert np.array_equal(sx.numpy(), np.asarray(s_j))
    pq, ps, pv = prologue.fused_prologue(port(x), None, bits=4, clip_ratio=0.9)
    assert pv is None and torch.equal(pq, xq) and torch.equal(ps, sx)


def test_reset_launches():
    actquant.LAUNCHES["act_quant_plain"] += 3
    actquant.reset_launches()
    assert actquant.LAUNCHES == {"act_quant": 0, "act_quant_plain": 0}


def test_plain_matches_pallas_kernel_in_interpret_mode(tmp_path):
    """``act_quant_kernel`` itself, in interpret mode (rows padded to its
    8-row tile with zeros and cut back); its scales are jitted
    (``torch_parity.scales_match_jitted``)."""
    x = _x(5, 5, 576)
    got = run_pallas(tmp_path, """
from repro.kernels.actquant import act_quant_kernel
x = np.pad(d["x"], ((0, 3), (0, 0)))
q, s = act_quant_kernel(jnp.asarray(x), bits=4, clip_ratio=0.9, bm=8)
out["q"], out["s"] = np.asarray(q)[:5], np.asarray(s)[:5]
""", x=x)
    xq, sx = actquant.act_quant(t(x), bits=4, clip_ratio=0.9)
    assert np.array_equal(xq.numpy(), got["q"])  # no code flips on these inputs
    assert scales_match_jitted(sx.numpy(), got["s"])


def test_build_digest_covers_the_shared_header(tmp_path, monkeypatch):
    """The quantizer lives in a header both kernels include: editing it must
    change the library both load, never leave a stale one in place."""
    from repro_torch.kernels import build

    for name in ("act_quant.cu", "fused_prologue.cu", "quant_rows.cuh"):
        (tmp_path / name).write_text((build.CSRC / name).read_text())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {n: build.target(n) for n in ("act_quant", "fused_prologue")}
    assert build.target("act_quant") == before["act_quant"]  # unchanged: reused
    (tmp_path / "quant_rows.cuh").write_text(
        (tmp_path / "quant_rows.cuh").read_text() + "\n// edited\n")
    for n, old in before.items():
        assert build.target(n) != old

"""The Walsh-Hadamard transform kernel's plain version against the
reference.

On the CPU the wrapper runs the plain version; the CUDA kernel is held
against that plain version on the card by ``chip_smoke.py``.

Tolerances: none.  Each output is a fixed tree of f32 adds and subtracts
and one multiply by the f32 value of ``1 / sqrt(d)``, so the plain version
is bitwise the reference's row body (``rowops.fwht_rows``) and its Pallas
kernel.  The reference's eager oracle (``core/hadamard.fwht``, which
divides by ``sqrt(d)``) is bitwise only where ``1 / sqrt(d)`` is exact
(d = 4^k): elsewhere it differs in the last bit."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hadamard as jhad
from repro.kernels import ref as jref
from repro.kernels import rowops as jrowops
from repro_torch.core.hadamard import fwht as core_fwht
from repro_torch.kernels import hadamard, ops, ref
from repro_torch.kernels.rowops import fwht_rows
from torch_parity import bf16, port, run_pallas, t


def _rows(seed, m, d):
    return (np.random.default_rng(seed).standard_normal((m, d)) * 3).astype(np.float32)


@pytest.mark.parametrize("d", [8, 128, 512, 1024, 8192])
def test_plain_bitwise_reference_row_body(d):
    x = _rows(d, 8, d)
    want = np.asarray(jrowops.fwht_rows(jnp.asarray(x), d))
    before = dict(hadamard.LAUNCHES)
    got = hadamard.fwht(t(x))
    # on the CPU the wrapper runs the plain version, never the kernel
    assert hadamard.LAUNCHES["fwht_plain"] == before["fwht_plain"] + 1
    assert hadamard.LAUNCHES["fwht"] == before["fwht"]
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(fwht_rows(t(x), d).numpy(), want)


@pytest.mark.parametrize("d", [512, 8192])
def test_dividing_form_is_not_the_kernels(d):
    """d = 2·4^k: dividing by sqrt(d) (the eager transform of both
    packages) and multiplying by 1/sqrt(d) (the kernels' row body) round
    differently; the port keeps both, each where the reference has it."""
    x = _rows(d + 1, 8, d)
    mult = hadamard.fwht_plain(t(x)).numpy()
    div = core_fwht(t(x)).numpy()
    assert np.array_equal(div, np.asarray(jhad.fwht(jnp.asarray(x))))
    assert np.array_equal(ref.fwht_ref(t(x)).numpy(),
                          np.asarray(jref.fwht_ref(jnp.asarray(x))))
    assert 0.2 < np.mean(mult != div) < 0.6
    np.testing.assert_allclose(mult, div, rtol=2 ** -22, atol=0)


def test_bf16_rounds_once_at_the_end():
    x = bf16(_rows(3, 5, 256))
    got = hadamard.fwht(port(x))
    assert got.dtype == torch.bfloat16
    want = fwht_rows(port(x).to(torch.float32), 256).to(torch.bfloat16)
    assert torch.equal(got, want)
    assert torch.equal(ops.fwht(port(x)), want)


@pytest.mark.parametrize("d", [0, 3, 96, 8194])
def test_width_must_be_a_power_of_two(d):
    with pytest.raises(ValueError):
        hadamard.fwht(torch.zeros((2, d)))


def test_host_constant_is_pythons():
    """The kernels multiply by (float)(1.0 / sqrt((double)d)), computed on
    the host; the plain version by 1.0 / d**0.5 rounded to f32.  The same
    f32 number for every power of two."""
    for e in range(21):
        d = 2 ** e
        assert np.float32(1.0 / math.sqrt(d)) == np.float32(1.0 / d**0.5), d


def test_reset_launches():
    hadamard.LAUNCHES["fwht_plain"] += 3
    hadamard.reset_launches()
    assert hadamard.LAUNCHES == {"fwht": 0, "fwht_plain": 0}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_bitwise_pallas_kernel_in_interpret_mode(tmp_path, dtype):
    """``fwht_kernel`` itself, in interpret mode, at d = 512 and 8192 (the
    widths where the dividing form differs) and a short one."""
    xs = {f"x{d}": _rows(d + 7, 8, d) for d in (16, 512, 8192)}
    if dtype == "bfloat16":
        xs = {k: bf16(v) for k, v in xs.items()}
    got = run_pallas(tmp_path, f"""
from repro.kernels.hadamard import fwht_kernel
for name, x in d.items():
    y = fwht_kernel(jnp.asarray(x, jnp.{dtype}), bm=8, interpret=True)
    out[name] = np.asarray(y.astype(jnp.float32))
""", **xs)
    for name, x in xs.items():
        y = hadamard.fwht(port(x))
        assert str(y.dtype) == f"torch.{dtype}"
        assert np.array_equal(y.to(torch.float32).numpy(), got[name]), name

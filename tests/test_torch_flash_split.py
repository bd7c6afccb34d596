"""The split of the dense flash kernels' three-pass TF32 products
(``repro_torch/kernels/flash_attn.py::tf32_split``, the plain-torch
``cvt.rna.tf32.f32`` that the card's probe in ``chip_smoke.py`` phase 3
compares the kernels' split with), held to premise 1 of the accuracy
standard in ``csrc/flash_attention.cuh``:

* the rounding is to nearest with ties away from zero, bitwise an
  independent reference (exact rational arithmetic on the value) for
  normal and subnormal f32;
* hi and lo are TF32 values (13 low bits clear) and |x - hi - lo| <=
  2⁻²²|x| + 2⁻¹³⁷;
* for f32 pairs a, b the kept terms hi·hi + hi·lo + lo·hi are within
  ``SPLIT_REL``·|a·b| (12(1 + 2⁻¹⁰)·2⁻²⁴, the standard's per-product
  term) of a·b, plus the floor ``SPLIT_FLOOR``·(|a| + |b|) where a
  residual is subnormal, all in exact arithmetic.

The f32 values are drawn by bit pattern, over exponent ranges from the
subnormals to the largest normals."""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.kernels import flash_attn

# premise 1's per-product term, relative to |a·b|, and its underflow floor
# per unit of |a| + |b|
SPLIT_REL = Fraction(12) * (1 + Fraction(1, 2 ** 10)) / 2 ** 24
SPLIT_FLOOR = Fraction(1, 2 ** 135)
# biased-exponent ranges of the drawn f32 (0: subnormal)
EXPONENTS = {"subnormal": (0, 0), "small": (1, 40), "unit": (100, 150),
             "large": (200, 253)}


def _f32(sign: bool, exponent: int, mantissa: int) -> float:
    bits = np.uint32((int(sign) << 31) | (exponent << 23) | mantissa)
    return float(bits.view(np.float32))


def _values(xs):
    return torch.tensor(xs, dtype=torch.float32)


def _rna_reference(x: float) -> Fraction:
    """x rounded to TF32 in exact arithmetic: the nearest multiple of the
    TF32 spacing at x (2^(e - 10) for a normal x in [2^e, 2^(e+1)), 2⁻¹³⁶
    below 2⁻¹²⁶, where f32's fixed subnormal spacing 2⁻¹⁴⁹ loses 13
    bits), ties away from zero; a value that reaches the next binade
    stays exact there."""
    if x == 0:
        return Fraction(0)
    mag = Fraction(abs(x))
    e = math.frexp(abs(x))[1] - 1  # abs(x) in [2^e, 2^(e+1))
    spacing = Fraction(2) ** (max(e, -126) - 10)
    k = math.floor(mag / spacing + Fraction(1, 2))
    return k * spacing if x > 0 else -k * spacing


@pytest.mark.parametrize("x, want", [
    (1.0, 1.0),
    (1 + 2 ** -11, 1 + 2 ** -10),          # a tie rounds away from zero
    (1 + 3 * 2 ** -11, 1 + 2 ** -9),       # ... also from an odd neighbour
    (-(1 + 2 ** -11), -(1 + 2 ** -10)),
    (1 + 2 ** -11 - 2 ** -23, 1.0),        # below a tie
    (2 - 2 ** -12, 2.0),                   # a carry into the exponent
    (2 ** -126, 2 ** -126),
    (0.0, 0.0),
])
def test_rounds_to_nearest_ties_away(x, want):
    hi, _ = flash_attn.tf32_split(_values([x]))
    assert hi.item() == want


@pytest.mark.parametrize("name", sorted(EXPONENTS))
@settings(max_examples=200, deadline=None)
@given(sign=st.booleans(), exponent=st.integers(0, 253), mantissa=st.integers(0, 2 ** 23 - 1))
def test_split_is_tf32_and_exact_to_2_22(name, sign, exponent, mantissa):
    lo_e, hi_e = EXPONENTS[name]
    x = _f32(sign, lo_e + exponent % (hi_e - lo_e + 1), mantissa)
    hi, lo = flash_attn.tf32_split(_values([x]))
    for t in (hi, lo):
        assert int(t.view(torch.int32).item()) & 0x1FFF == 0
    assert Fraction(hi.item()) == _rna_reference(x)
    assert Fraction(lo.item()) == _rna_reference(x - hi.item())
    resid = abs(Fraction(x) - Fraction(hi.item()) - Fraction(lo.item()))
    assert resid <= Fraction(2) ** -22 * abs(Fraction(x)) + Fraction(2) ** -137


@pytest.mark.parametrize("name_a, name_b", [("unit", "unit"), ("small", "large"),
                                            ("unit", "subnormal"), ("large", "small"),
                                            ("small", "small")])
@settings(max_examples=200, deadline=None)
@given(sa=st.booleans(), ea=st.integers(0, 253), ma=st.integers(0, 2 ** 23 - 1),
       sb=st.booleans(), eb=st.integers(0, 253), mb=st.integers(0, 2 ** 23 - 1))
def test_three_passes_within_the_per_product_term(name_a, name_b, sa, ea, ma, sb, eb, mb):
    def draw(name, s, e, m):
        lo_e, hi_e = EXPONENTS[name]
        return _f32(s, lo_e + e % (hi_e - lo_e + 1), m)

    a, b = draw(name_a, sa, ea, ma), draw(name_b, sb, eb, mb)
    (ha, la), (hb, lb) = (tuple(Fraction(t.item()) for t in flash_attn.tf32_split(_values([v])))
                          for v in (a, b))
    fa, fb = Fraction(a), Fraction(b)
    err = abs(fa * fb - (ha * hb + ha * lb + la * hb))
    limit = SPLIT_REL * abs(fa * fb) + SPLIT_FLOOR * (abs(fa) + abs(fb))
    assert err <= limit


def test_probe_plain_is_the_exact_product():
    """The probe's plain version (what ``tc_probe`` runs on the CPU): the
    split of x and c + a·btᵀ summed exactly, then rounded once."""
    a = torch.zeros((16, 8))
    a[0, :] = 2.0 ** -24
    bt = torch.zeros((8, 8))
    bt[0] = 1.0
    c = torch.zeros((16, 8))
    c[0] = 1.0
    x = _values([1 + 2 ** -11, 3.0])
    hi, lo, hi_cvt, lo_cvt, d = flash_attn.tc_probe(x, a, bt, c)
    assert hi.tolist() == [1 + 2 ** -10, 3.0] and lo.tolist() == [-(2 ** -11), 0.0]
    assert torch.equal(hi_cvt, hi) and torch.equal(lo_cvt, lo)
    assert d[0, 0].item() == np.float32(1 + 8 * 2.0 ** -24)  # 1 + 2⁻²¹, exact in f32
    assert torch.equal(d[0, 1:], c[0, 1:]) and torch.equal(d[1:], c[1:])

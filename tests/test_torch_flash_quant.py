"""The port's dense flash attention over quantized K/V (kernel #8's plain
version, ``repro_torch/kernels/flash_attn.py::flash_attention_quant_plain``)
and the query offset ``q_start`` of #7 and #8, against the reference on
the same numpy inputs: its Pallas ``flash_attention_quant_kernel`` in
interpret mode (in process: the flash kernels run on the installed jax)
and its plain ``models/common.py::attention`` under ``causal_mask(q_len,
kv_len, q_offset)``.

Tolerances (``torch_parity.flash_bound``; u = 2⁻²⁴, S = Σ_d
|q_d·scale|·max_keys |k_d| per query row over the dequantized K, N = qpos
+ 1 keys with qpos = q_start + row, tiles = ⌈N/128⌉, v_max = max |v| of
the kv head):

* against Pallas: both dequantize each element with one f32 multiply
  (bitwise alike) and take the same f32 steps on the same 128-row key
  tiles, differing only in the order of three sums (the D-term score dot,
  Σp and p·V): 2·v_max·(2·D·u·S + 2·(N + 2·tiles + 4)·u); a bf16 output
  adds one bf16 ulp of the larger side (2⁻⁶|y|).
* against ``attention``: one more rounding per score (scale after the
  product: D + 1 in place of D), one normalization over all N keys (in the
  N-term); with bf16 inputs the logits and probabilities round to bf16 as
  well (``attention_bound`` of ``test_torch_flash_prefill``).
* #8 on codes against #7 on ``dequantize_kv`` of the same codes: bitwise
  (the same steps on the same f32 values).
* the rows of a ``q_start = s0`` call against rows s0… of the ``q_start =
  0`` call over the same K/V: the same function of the same keys, so
  within the bound above.  On the card the kernel holds them bitwise
  (``chip_smoke.py`` phase 3); the CPU's batched products sum a row's D
  terms in an order that depends on the number of rows, so the plain
  version is held to the bound here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.models.common import attention as jax_attention
from repro.models.common import causal_mask as jax_causal_mask
from repro.serve.kvquant import KVSpec as JaxKVSpec
from repro_torch import bridge
from repro_torch.kernels import flash_attn, ops
from repro_torch.serve.kvquant import KVSpec, dequantize_kv, quantize_kv
from torch_parity import bf16, flash_bound, port

H, KH, D = 4, 2, 64
SPECS = [KVSpec("int8"), KVSpec("int8", group=32), KVSpec("int4"),
         KVSpec("int4", group=32)]


def _as_np(t):
    return bridge.tensor_to_numpy(t, bf16_dtype=jnp.bfloat16.dtype)


def _problem(seed, b, sq, skv, spec, q_dtype="float32"):
    """q (B, Sq, H, D) numpy (bf16 if asked); the port's codes and scales of
    random K/V (B, Skv, KH, D) as tensors; their dequantized f32 values."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, H, D)).astype(np.float32)
    if q_dtype == "bfloat16":
        q = bf16(q)
    kv = []
    for _ in range(2):
        x = (rng.standard_normal((b, skv, KH, D)) * 1.5).astype(np.float32)
        codes, scales = quantize_kv(torch.from_numpy(x), spec)
        kv += [codes, scales]
    deq = [dequantize_kv(kv[i], kv[i + 1], spec, D) for i in (0, 2)]
    return q, kv, deq


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s", [(2, 64), (1, 256)])
@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.describe())
def test_plain_matches_pallas(spec, b, s, q_dtype):
    """GQA (H 4, KH 2), int8 and int4, group = D and 32, S <= 128 and a
    multiple of 128 (what the reference wrapper takes), f32 and bf16 q."""
    q, kv, (kd, vd) = _problem(s + len(spec.describe()), b, s, s, spec, q_dtype)
    scale = D ** -0.5
    want = np.asarray(jax_ops.flash_attention_quant(
        jnp.asarray(q), *(jnp.asarray(t.numpy()) for t in kv), scale,
        JaxKVSpec(spec.dtype, spec.group)))
    got = flash_attn.flash_attention_quant_plain(port(q), *kv, scale, spec)
    assert got.dtype == port(q).dtype and tuple(got.shape) == (b, s, H, D)
    tol, _, _ = flash_bound(q, kd.numpy(), vd.numpy(), scale, want)
    err = np.abs(np.asarray(_as_np(got), np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= tol)


@pytest.mark.parametrize("q_start", [None, (0, 0), (5, 130)])
@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.describe())
def test_quant_plain_is_plain_on_dequantized(spec, q_start):
    """#8 on codes is bitwise #7 on ``dequantize_kv`` of the codes, with
    and without a query offset, over a ragged S."""
    q, kv, (kd, vd) = _problem(3, 2, 70, 200, spec)
    qs = None if q_start is None else torch.tensor(q_start, dtype=torch.int32)
    a = flash_attn.flash_attention_quant_plain(port(q), *kv, 0.125, spec, q_start=qs)
    b = flash_attn.flash_attention_plain(port(q), kd, vd, 0.125, q_start=qs)
    assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["float", "int8", "int4-g32"])
@pytest.mark.parametrize("s0,width", [(1, 3), (37, 100), (128, 5), (199, 1)])
def test_q_start_rows_match_full_call(kind, s0, width):
    """Rows s0 … s0 + width - 1 asked for with ``q_start = s0`` are rows s0…
    of one ``q_start = 0`` call over the same K/V (each row at a different
    offset in B), within the bound; every key above a row's diagonal
    stays out of it."""
    spec = SPECS[1] if kind == "int8" else SPECS[3]
    q, kv, (kd, vd) = _problem(7, 2, 200, 200, spec)
    offs = [s0, max(s0 - 1, 0)]
    if kind == "float":
        def call(qq, qs):
            return flash_attn.flash_attention_plain(qq, kd, vd, 0.125, q_start=qs)
    else:
        def call(qq, qs):
            return flash_attn.flash_attention_quant_plain(qq, *kv, 0.125, spec,
                                                          q_start=qs)
    full = call(port(q), None).numpy()
    qq = np.stack([q[i, o:o + width] for i, o in enumerate(offs)])
    part = call(port(qq), torch.tensor(offs, dtype=torch.int32)).numpy()
    for i, o in enumerate(offs):
        tol, _, _ = flash_bound(qq[i:i + 1], kd[i:i + 1].numpy(), vd[i:i + 1].numpy(),
                                0.125, part[i:i + 1], q_start=o)
        assert np.all(np.abs(part[i] - full[i, o:o + width]) <= tol[0])


def attention_bound(q, k, v, scale, y, q_start):
    tol, s_max, vmax = flash_bound(q, k, v, scale, y, extra_dot=1, q_start=q_start)
    if y.dtype.name == "bfloat16":
        tol = tol + 2 * vmax * 2 * 2.0 ** -9 * s_max + 2.0 ** -9 * vmax
    return tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_start,sq,skv", [(0, 50, 50), (6, 4, 16), (130, 70, 256),
                                            (255, 1, 260)])
def test_plain_with_q_start_matches_attention(q_start, sq, skv, dtype):
    """#7 with an offset against ``attention`` under ``causal_mask(Sq, Skv,
    q_start)`` (keys past the last query row present, masked)."""
    rng = np.random.default_rng(q_start + sq)
    q, k, v = (rng.standard_normal((2, n, heads, D)).astype(np.float32)
               for n, heads in ((sq, H), (skv, KH), (skv, KH)))
    if dtype == "bfloat16":
        q, k, v = bf16(q), bf16(k), bf16(v)
    scale = D ** -0.5
    want = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jax_causal_mask(sq, skv, q_start), scale))
    qs = torch.full((2,), q_start, dtype=torch.int32)
    got = _as_np(flash_attn.flash_attention_plain(port(q), port(k), port(v), scale,
                                                  q_start=qs))
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= attention_bound(q, k, v, scale, want, q_start))


@pytest.mark.parametrize("spec", [SPECS[1], SPECS[2]], ids=lambda s: s.describe())
@pytest.mark.parametrize("q_start,sq,skv", [(0, 64, 64), (9, 7, 20), (140, 30, 200)])
def test_quant_plain_with_q_start_matches_attention(spec, q_start, sq, skv):
    """#8 with an offset against ``attention`` on the dequantized K/V (the
    reference's gather route over a quantized pool) under ``causal_mask``."""
    rng = np.random.default_rng(sq)
    q = rng.standard_normal((2, sq, H, D)).astype(np.float32)
    _, kv, (kd, vd) = _problem(q_start, 2, 1, skv, spec)
    scale = D ** -0.5
    want = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(kd.numpy()),
                                    jnp.asarray(vd.numpy()),
                                    jax_causal_mask(sq, skv, q_start), scale))
    got = ops.flash_attention_quant(port(q), *kv, scale, spec,
                                    q_start=torch.full((2,), q_start, dtype=torch.int32))
    err = np.abs(got.numpy().astype(np.float64) - want)
    assert np.all(err <= attention_bound(q, kd.numpy(), vd.numpy(), scale, want, q_start))


def test_launch_counts_and_devices():
    spec = SPECS[0]
    q, kv, (kd, vd) = _problem(1, 1, 8, 8, spec)
    flash_attn.reset_launches()
    ops.flash_attention_quant(port(q), *kv, 0.125, spec)
    ops.flash_attention(port(q), kd, vd, 0.125, q_start=torch.zeros(1, dtype=torch.int32))
    want = {k: 0 for k in flash_attn.LAUNCHES}
    want.update(flash_attention_quant_plain=1, flash_attention_plain=1)
    assert flash_attn.LAUNCHES == want
    meta = torch.zeros((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attn.flash_attention_quant(meta, meta, meta, meta, meta, 0.25, spec)

"""The port's paged decode attention (``repro_torch/kernels/flash_attn.py``)
against the reference's Pallas kernels, run in-process in interpret mode
(``repro.kernels.ops.paged_flash_attention[_quant]``; unlike the W4A4
kernels these run on the installed jax), on the same numpy inputs.

The inputs are what the serving engine hands the kernels: a shared pool
whose pages are owned by disjoint, shuffled block-table rows, ragged
lengths (one ending mid-page, one of a single token, one inactive row of
length 0), large finite garbage in the null page and in every page no row
owns, and GQA groups of 1 and 2 query heads per kv head.

Tolerance (:func:`attention_bound`): the plain version and the Pallas body
take the same steps in f32 and differ only in the order of three sums —
the D-term score dot, the P-term Σp and the P-term p·V.  A score then
differs by at most 2·D·u·S (u = 2⁻²⁴, S = the largest Σ_d |q_d·scale·k_d|
of a valid token), which moves each softmax weight by at most a relative
2·D·u·S + a few u, and the two sums add 2·(N + 2·pages + 4)·u relative
error over N valid tokens; each moves the output by at most that fraction
of max |v|.  The bound is twice the sum of the two terms, times max |v|.
Rows of length 0 are compared with nothing: their output is garbage the
engine ignores."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.serve.kvquant import KVSpec as JaxKVSpec
from repro.serve.kvquant import quantize_kv as jax_quantize_kv
from repro_torch.kernels import flash_attn, ops
from repro_torch.models.common import attention
from repro_torch.serve.kvquant import KVSpec, dequantize_kv, quantize_kv
from torch_parity import bf16, port

U = 2.0 ** -24
PAGE, MPB, NUM_PAGES = 4, 5, 23
LENGTHS = (7, 13, 0, 1, 20)  # mid-page, mid-page, inactive, one token, full
SPECS = [KVSpec("int8"), KVSpec("int8", group=8), KVSpec("int4"),
         KVSpec("int4", group=8)]


def attention_bound(q, k_rows, v_rows, lengths, scale):
    """Per (row, head) bound on |plain - reference| (module docstring).
    q (B, H, D) and the rows (B, N_max, KH, D|Dv) as f64 numpy, dense in
    position order."""
    b, h, d = q.shape
    kh = k_rows.shape[2]
    out = np.zeros((b, h))
    for i, n in enumerate(lengths):
        if n == 0:
            continue
        k = np.repeat(np.abs(k_rows[i, :n]), h // kh, axis=1)  # (n, H, D)
        s_max = (np.abs(q[i] * scale)[None] * k).sum(-1).max(0)  # (H,)
        v_max = np.abs(v_rows[i, :n]).max()
        pages = -(-n // PAGE)
        out[i] = 2 * v_max * (2 * d * U * s_max + 2 * (n + 2 * pages + 4) * U)
    return out[..., None]


def paged_problem(seed, h, kh, d, dtype=np.float32, garbage=40.0):
    """q, a garbage-filled pool with each row's pages on disjoint shuffled
    ids, and the dense per-row K/V in position order (f32 numpy)."""
    rng = np.random.default_rng(seed)
    b = len(LENGTHS)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    pools = [(rng.standard_normal((NUM_PAGES, PAGE, kh, d)) * garbage).astype(dtype)
             for _ in range(2)]
    rows = [rng.standard_normal((b, MPB * PAGE, kh, d)).astype(dtype)
            for _ in range(2)]
    ids = rng.permutation(np.arange(1, NUM_PAGES))
    table = np.zeros((b, MPB), np.int32)
    taken = 0
    for i, n in enumerate(LENGTHS):
        need = -(-n // PAGE)
        mine = ids[taken:taken + need]
        taken += need
        table[i, :need] = mine
        for j, pid in enumerate(mine):
            for pool, r in zip(pools, rows):
                pool[pid] = r[i, j * PAGE:(j + 1) * PAGE]
    return q, pools, rows, table, np.asarray(LENGTHS, np.int32)


def _valid(a):
    return np.asarray(a, np.float64)[np.asarray(LENGTHS) > 0]


@pytest.mark.parametrize("pool_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("heads", [(2, 2), (4, 2)], ids=["G1", "G2"])
def test_plain_matches_pallas(pool_dtype, heads):
    h, kh = heads
    d = 16
    q, (kp, vp), (kr, vr), table, lengths = paged_problem(1, h, kh, d)
    if pool_dtype == "bf16":
        kp, vp, kr, vr = bf16(kp), bf16(vp), bf16(kr), bf16(vr)
    scale = d ** -0.5
    want = np.asarray(jax_ops.paged_flash_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lengths), scale))
    flash_attn.reset_launches()
    got = ops.paged_flash_attention(port(q), port(kp), port(vp), port(table),
                                    port(lengths), scale)
    assert flash_attn.LAUNCHES["paged_flash_attention_plain"] == 1
    assert flash_attn.LAUNCHES["paged_flash_attention"] == 0
    assert got.dtype == torch.float32 and got.shape == (len(LENGTHS), h, d)
    got = got.numpy()
    assert np.all(np.isfinite(got))
    bound = attention_bound(q, np.asarray(kr, np.float64), np.asarray(vr, np.float64),
                            LENGTHS, scale)
    err = np.abs(_valid(got) - _valid(want))
    assert np.all(err <= bound[np.asarray(LENGTHS) > 0]), err.max()


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.describe())
@pytest.mark.parametrize("heads", [(2, 2), (4, 2)], ids=["G1", "G2"])
def test_quant_plain_matches_pallas(spec, heads):
    """Codes and scales come from the port's ``quantize_kv`` (bitwise the
    reference's, ``test_torch_kvquant``); the garbage elsewhere is random
    codes and large finite scales."""
    h, kh = heads
    d = 32
    q, _, (kr, vr), table, lengths = paged_problem(2, h, kh, d)
    rng = np.random.default_rng(3)
    n_g, phd = spec.n_groups(d), spec.packed_head_dim(d)
    pools = []
    for rows in (kr, vr):
        codes = rng.integers(-128, 128, (NUM_PAGES, PAGE, kh, phd)).astype(
            np.uint8 if spec.dtype == "int4" else np.int8)
        scales = (rng.standard_normal((NUM_PAGES, PAGE, kh, n_g)) * 7).astype(np.float32)
        rq, rs = quantize_kv(torch.from_numpy(rows), spec)
        for i, n in enumerate(LENGTHS):
            for j in range(-(-n // PAGE)):
                codes[table[i, j]] = rq[i, j * PAGE:(j + 1) * PAGE].numpy()
                scales[table[i, j]] = rs[i, j * PAGE:(j + 1) * PAGE].numpy()
        dense = dequantize_kv(rq, rs, spec, d).numpy().astype(np.float64)
        pools.append((codes, scales, dense))
    (kc, ks, kd), (vc, vs, vd) = pools
    scale = d ** -0.5
    want = np.asarray(jax_ops.paged_flash_attention_quant(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(ks), jnp.asarray(vc),
        jnp.asarray(vs), jnp.asarray(table), jnp.asarray(lengths), scale,
        JaxKVSpec(spec.dtype, spec.group)))
    flash_attn.reset_launches()
    got = ops.paged_flash_attention_quant(
        port(q), port(kc), port(ks), port(vc), port(vs), port(table),
        port(lengths), scale, spec).numpy()
    assert flash_attn.LAUNCHES["paged_flash_attention_quant_plain"] == 1
    assert flash_attn.LAUNCHES["paged_flash_attention_quant"] == 0
    assert np.all(np.isfinite(got))
    bound = attention_bound(q, kd, vd, LENGTHS, scale)
    err = np.abs(_valid(got) - _valid(want))
    assert np.all(err <= bound[np.asarray(LENGTHS) > 0]), err.max()


def test_plain_matches_gathered_attention():
    """The plain version against the reference's serving-path math on the
    same pages (the port's ``attention`` over each row's gathered pages,
    all f32), to the same bound: one softmax over all positions against an
    online one, so again only the order of the f32 sums differs."""
    h, kh, d = 4, 2, 16
    q, (kp, vp), (kr, vr), table, lengths = paged_problem(4, h, kh, d)
    scale = d ** -0.5
    got = flash_attn.paged_flash_attention_plain(
        port(q), port(kp), port(vp), port(table), port(lengths), scale).numpy()
    bt = torch.from_numpy(table).long()
    kc = port(kp)[bt].reshape(len(LENGTHS), -1, kh, d)
    vc = port(vp)[bt].reshape(len(LENGTHS), -1, kh, d)
    mask = torch.arange(MPB * PAGE)[None, None, :] < port(lengths)[:, None, None]
    want = attention(port(q)[:, None], kc, vc, mask, scale)[:, 0].numpy()
    bound = attention_bound(q, kr.astype(np.float64), vr.astype(np.float64),
                            LENGTHS, scale)
    err = np.abs(_valid(got) - _valid(want))
    assert np.all(err <= bound[np.asarray(LENGTHS) > 0]), err.max()


def test_output_keeps_q_dtype_and_ignores_garbage():
    """bf16 q gives bf16 output (as served); the result does not move when
    the garbage in unowned pages and the null page is replaced."""
    h, kh, d = 4, 2, 16
    q, (kp, vp), _, table, lengths = paged_problem(5, h, kh, d)
    scale = d ** -0.5
    qb = port(q).to(torch.bfloat16)
    out = flash_attn.paged_flash_attention(qb, port(kp), port(vp), port(table),
                                           port(lengths), scale)
    assert out.dtype == torch.bfloat16
    owned = set(table[table > 0].tolist())
    rng = np.random.default_rng(6)
    for pid in range(NUM_PAGES):
        if pid not in owned:
            kp[pid] = rng.standard_normal(kp[pid].shape) * 1e3
            vp[pid] = rng.standard_normal(vp[pid].shape) * 1e3
    again = flash_attn.paged_flash_attention(qb, port(kp), port(vp), port(table),
                                             port(lengths), scale)
    ok = np.asarray(LENGTHS) > 0
    assert torch.equal(out[ok], again[ok])


def test_quantized_operands_are_dequantize_kv():
    """The quant plain version attends over exactly ``dequantize_kv``'s
    operands: it equals the float plain version run on the dequantized
    pool, bitwise."""
    spec = KVSpec("int4", group=8)
    h, kh, d = 4, 2, 16
    q, (kp, vp), _, table, lengths = paged_problem(7, h, kh, d)
    kc, ks = quantize_kv(port(kp), spec)
    vc, vs = quantize_kv(port(vp), spec)
    scale = d ** -0.5
    got = flash_attn.paged_flash_attention_quant_plain(
        port(q), kc, ks, vc, vs, port(table), port(lengths), scale, spec)
    want = flash_attn.paged_flash_attention_plain(
        port(q), dequantize_kv(kc, ks, spec, d), dequantize_kv(vc, vs, spec, d),
        port(table), port(lengths), scale)
    assert torch.equal(got, want)


def test_quantize_kv_matches_the_reference_on_pool_rows():
    """The codes the kernels read are the reference's (the pool of the
    quant tests is written by the port's quantizer)."""
    rows = np.random.default_rng(8).standard_normal((3, PAGE, 2, 32)).astype(np.float32)
    for spec in SPECS:
        jq, js = jax_quantize_kv(jnp.asarray(rows), JaxKVSpec(spec.dtype, spec.group))
        tq, ts = quantize_kv(torch.from_numpy(rows), spec)
        assert np.array_equal(np.asarray(jq), tq.numpy())
        assert np.array_equal(np.asarray(js), ts.numpy())


def test_wrappers_refuse_other_devices():
    q = torch.zeros((1, 2, 16), device="meta")
    pages = torch.zeros((3, PAGE, 2, 16), device="meta")
    table = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    lengths = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attn.paged_flash_attention(q, pages, pages, table, lengths, 0.25)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attn.paged_flash_attention_quant(q, pages, pages, pages, pages,
                                               table, lengths, 0.25, KVSpec("int8"))

"""Attention on Hopper: four kernels, their plain versions and their
launch counters.

The kernels (CUDA C++ for sm_90a) replace the TPU kernels of
``repro/kernels/flash_attn.py``:

- ``csrc/flash_attention.cu`` ← ``flash_attention_kernel``: causal GQA
  flash attention over q (B, Sq, H, D) and f32 / bf16 k/v (B, Skv, KH, D)
  in place (:func:`flash_attention`; the calibration walk's and the
  cache-free forward's attention, and a prefill chunk's over a float pool);
- ``csrc/flash_attention_quant.cu`` ← ``flash_attention_quant_kernel``:
  the same over int8 or packed-int4 k/v with their f32 scale planes, each
  tile dequantized on chip (:func:`flash_attention_quant`; a prefill
  chunk's attention over a quantized pool);
- ``csrc/paged_flash_attention.cu`` ← ``paged_flash_attention_kernel``, for
  f32 and bf16 pools;
- ``csrc/paged_flash_attention_quant.cu`` ←
  ``paged_flash_attention_quant_kernel``, for int8 and packed-int4 pools
  with their f32 scale planes.

The two dense kernels (body in ``csrc/flash_attention.cuh``) compute
both products on the tensor cores (``mma.sync`` m16n8k8 in TF32, three
passes over each f32 operand split as :func:`tf32_split` does; the accuracy
standard that holds them to their plain versions is stated at the head of
the body and in ``chip_smoke.py::_flash_tolerance``) and take head dims up
to ``MAX_D`` = 256.  They take a query offset: query row i of sequence b
sits at absolute position q_start[b] + i (``q_start`` (B,) int32, default
0) and key positions count from 0, in key tiles of ``KV_TILE`` rows
anchored at key 0.  A tile wholly above a row's diagonal is then an exact
no-op for it, so a row's result is bitwise the same whatever chunk of its
prompt it arrived in.  :func:`tc_probe` runs the body's split and one
tensor-core product on chosen inputs, for the card's check of the
standard's premises.

The two paged kernels (body in ``csrc/paged_attention.cuh``) compute, for
one query token per sequence,

    out (B, H, D) = softmax(q·scale · Kᵀ, positions >= lengths masked) · V

with K/V read in place from one layer's page pool (NP, P, KH, ·) through
the block table (B, MPB) int32.  The wrappers copy, transpose and cast no
pool: the Pallas wrapper's (KH, NP, P, D) transpose of the whole pool would
cost more than the attention at long context.  A row's keys are split by
a rule fixed per row, ``PAGES_PER_SPLIT`` pages a split, over a grid of
(kv head, row, split) blocks with S = :func:`paged_splits` (MPB) splits
from shapes alone; each block's ``SPLIT_WARPS`` warps take its tokens in
steps, read each K/V row with 16-byte loads where the row allows it, and
meet in warp order.  With S == 1 (every served shape) a block writes the
output; with S > 1 the wrapper allocates an f32 workspace of (S, B, H,
Dv + 2) partials and the same C call launches a combine that adds a
row's splits in ascending order.  So a row's output is bitwise the same
whatever rows share the call, wherever its pages sit and whatever MPB
the table has.  The kernel's order of operations differs from the plain
version's page-by-page order; :func:`paged_attention_bound` holds the two
together (derived at the head of the body).

Bound of the paged kernels on an H100 SXM (3.35 TB/s): memory — the valid
K/V rows (plus their scales), q and the output; of the dense kernels:
their f32 operations, three TF32 passes of them on the tensor cores.  Each
wrapper takes its plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises, and reads nothing back to the host.
``LAUNCHES`` counts each wrapper call once.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rowops import scalar

LAUNCHES = {"flash_attention": 0, "flash_attention_plain": 0,
            "flash_attention_quant": 0, "flash_attention_quant_plain": 0,
            "paged_flash_attention": 0, "paged_flash_attention_plain": 0,
            "paged_flash_attention_quant": 0,
            "paged_flash_attention_quant_plain": 0}
NEG_INF = -1e30
# the key tile of the dense kernel, its plain version and the reference
# wrapper (``bkv = min(128, Skv)``): the per-tile maxima follow it
KV_TILE = 128
# the largest head dims the dense kernels take (MAX_D of
# csrc/flash_attention.cuh, which chip_smoke.py holds against the built
# library): the "auto" attention route demotes wider heads to gather
MAX_D = 256
# the paged kernels' split (PAGES_PER_SPLIT and WARPS of
# csrc/paged_attention.cuh, which chip_smoke.py holds against the built
# libraries): a row's keys in splits of this many pages, each split's
# tokens in steps taken by this many warps in turn
PAGES_PER_SPLIT = 16
SPLIT_WARPS = 4


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` in plain torch: round the f32 x to the nearest
    value with 10 explicit significand bits, ties away from zero, the 13
    low bits cleared (finite x)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """The dense kernels' split of each f32 operand x: ``hi`` = x rounded to
    TF32, ``lo`` = (x - hi) rounded to TF32 (x - hi is exact in f32), so
    |x - hi - lo| <= 2⁻²²|x|.  Returns (hi, lo), both f32 tensors of TF32
    values."""
    x = x.to(torch.float32)
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def paged_splits(mpb: int) -> int:
    """S, the splits of a paged kernel call over a block table of ``mpb``
    pages a row: max(1, ceil(MPB / PAGES_PER_SPLIT)), from shapes alone."""
    return max(1, -(-mpb // PAGES_PER_SPLIT))


def paged_attention_bound(q, kd, vd, lengths, scale: float, page: int,
                          y_plain) -> torch.Tensor:
    """Elementwise bound on |kernel - plain| of paged decode attention
    (#6, #9), the accuracy standard of the split-KV body, derived at the
    head of ``csrc/paged_attention.cuh`` from the two orders of operations
    (stated before the body's first card run, never fitted to measured
    errors).  u = 2⁻²⁴; per row of length n (clamped to MPB·P), pages =
    ceil(n / P), ns = ceil(pages / PAGES_PER_SPLIT), n_w = ceil(min(n,
    PAGES_PER_SPLIT·P) / SPLIT_WARPS) (a warp's steps at most), S = the
    largest Σ_d |q·scale·k_d| of a valid token of the query row, v_max =
    max |v| over the row's valid rows:

    * weights: each version's are the exact softmax weights times factors
      within e^(±E): E = D·u·S (its dot) + 5u per expf on a token's path
      (2 ulp of the correctly rounded result, CUDA's documented maximum;
      kernel n_w + 2 of them: p, later steps' corr, the warp's and the
      split's factors; plain ``pages``: p and later pages' corr) + u·x̄
      (the rounded differences of scores and maxima, x̄ <= min(n/e, 2S));
      that moves the output by at most 2c/(1 - c)·v_max, c = e^E - 1;
    * sums: each rounding of acc or l moves the output by at most u·v_max
      along a token's path: kernel acc and l 2n_w + ns + 17 each (passes,
      steps, the groups' xor tree, the warp merge, the split combine),
      plain P + 2·pages each, and each final division once;
    * a bf16 output adds one bf16 ulp of the larger side (2⁻⁶·|plain|).

    q (B, H, D) as the kernel got it; kd, vd (B, MPB·P, KH, D|Dv) the
    rows' K and V as the kernel attends over them (f32; a quantized pool's
    codes dequantized); lengths (B,); y_plain the plain version's output.
    Returns (B, H, 1) float64."""
    u = 2.0 ** -24
    f64 = torch.float64
    b, h, d = q.shape
    kh = kd.shape[2]
    g = h // kh
    pos = torch.arange(kd.shape[1], device=q.device)
    n = lengths.to(q.device).long().clamp(0, kd.shape[1])
    valid = pos[None, :] < n[:, None]  # (B, S)
    qs = (q.float() * scalar(scale, q.float())).double().abs().reshape(b, kh, g, d)
    s_abs = torch.einsum("bkgd,bskd->bkgs", qs, kd.double().abs())
    s_max = torch.where(valid[:, None, None], s_abs, 0.0).amax(-1)  # (B, KH, G)
    v_max = torch.where(valid[:, :, None, None], vd.double().abs(), 0.0).amax((1, 2, 3))
    n = n.to(f64)
    pages = torch.ceil(n / page)
    ns = torch.ceil(pages / PAGES_PER_SPLIT)
    n_w = torch.ceil(torch.minimum(n, torch.full_like(n, PAGES_PER_SPLIT * page))
                     / SPLIT_WARPS)
    col = (slice(None), None, None)
    x_bar = torch.minimum((n / math.e)[col], 2 * s_max)
    e_k = d * u * s_max + (5 * u * (n_w + 2))[col] + u * x_bar
    e_p = d * u * s_max + (5 * u * pages)[col] + u * x_bar
    c_k, c_p = torch.expm1(e_k), torch.expm1(e_p)
    sums = (4 * n_w + 2 * ns + 34 + 2 * page + 4 * pages + 2) * u * (1 + 2.0 ** -8)
    tol = v_max[col] * (2 * c_k / (1 - c_k) + 2 * c_p / (1 - c_p) + sums[col])
    tol = tol.to(f64).reshape(b, h, 1)
    if y_plain.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -6 * y_plain.double().abs()
    return tol


def _online_softmax(q, block_table, lengths, scale, page_rows):
    """The Pallas bodies (``_paged_kernel``, ``_paged_kernel_quant``) step
    by step, batched over sequences and kv heads: q in f32 times ``scale``
    first; per page in ascending block-table order the scores, the -1e30
    mask at positions >= length, the running max, ``corr``, ``l`` and
    ``acc``; then ``acc / max(l, 1e-30)`` in q's dtype.  ``page_rows(pids)``
    returns the f32 K and V of pages ``pids`` (B,) as (B, P, KH, D|Dv)."""
    b, h, d = q.shape
    f32 = torch.float32
    bt = block_table.long()
    m = l = acc = None
    for j in range(bt.shape[1]):
        k, v = page_rows(bt[:, j])
        page, kh = k.shape[1], k.shape[2]
        if m is None:
            g = h // kh
            qf = q.to(f32).reshape(b, kh, g, d)
            qf = qf * scalar(scale, qf)
            m = torch.full((b, kh, g, 1), NEG_INF, dtype=f32, device=q.device)
            l = torch.zeros((b, kh, g, 1), dtype=f32, device=q.device)
            acc = torch.zeros((b, kh, g, v.shape[-1]), dtype=f32, device=q.device)
        s = qf @ k.permute(0, 2, 3, 1)  # (B, KH, G, P)
        kpos = j * page + torch.arange(page, device=q.device)
        s = torch.where(kpos < lengths.reshape(b, 1, 1, 1), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + p @ v.permute(0, 2, 1, 3)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(b, h, -1).to(q.dtype)


def _causal_online_softmax(q, tiles, skv: int, dv: int, scale: float,
                           causal: bool, q_start):
    """The dense Pallas bodies (``_kernel``, ``_kernel_quant``) step by
    step, batched over sequences, heads and every query row (a row's result
    does not depend on its query tile): q in f32 times ``scale`` first; per
    key tile of ``min(KV_TILE, Skv)`` rows from key 0, ascending, the
    scores, -1e30 where kpos > qpos (query row i of sequence b at
    ``q_start[b] + i``), the running max, ``corr``, ``l`` and ``acc``; then
    ``acc / max(l, 1e-30)`` in q's dtype.  ``tiles(k0, k1)`` returns the f32
    K and V rows k0…k1-1 as (B, T, KH, D|Dv).  Returns (B, Sq, H, Dv)."""
    b, sq, h, d = q.shape
    f32 = torch.float32
    m = l = acc = qf = None
    qpos = torch.arange(sq, device=q.device)[None, :]
    if q_start is not None:
        qpos = qpos + q_start.to(q.device).long()[:, None]
    qpos = qpos[:, None, None, :, None]  # (B|1, 1, 1, Sq, 1)
    bkv = min(KV_TILE, skv)
    for k0 in range(0, skv, bkv):
        k, v = tiles(k0, min(k0 + bkv, skv))
        kh = k.shape[2]
        if m is None:
            g = h // kh
            qf = q.to(f32).reshape(b, sq, kh, g, d).permute(0, 2, 3, 1, 4)  # (B,KH,G,Sq,D)
            qf = qf * scalar(scale, qf)
            m = torch.full((b, kh, g, sq, 1), NEG_INF, dtype=f32, device=q.device)
            l = torch.zeros((b, kh, g, sq, 1), dtype=f32, device=q.device)
            acc = torch.zeros((b, kh, g, sq, dv), dtype=f32, device=q.device)
        kt = k.permute(0, 2, 1, 3)[:, :, None]  # (B,KH,1,T,D)
        vt = v.permute(0, 2, 1, 3)[:, :, None]
        s = qf @ kt.transpose(-1, -2)  # (B, KH, G, Sq, T)
        if causal:
            kpos = k0 + torch.arange(kt.shape[3], device=q.device)
            s = torch.where(kpos <= qpos, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + p @ vt
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv).to(q.dtype)


def flash_attention_plain(q, k, v, scale: float, causal: bool = True,
                          q_start=None) -> torch.Tensor:
    """Kernel #7's function in plain torch (:func:`_causal_online_softmax`
    on k/v in f32).  q (B, Sq, H, D), k/v (B, Skv, KH, D|Dv) f32 or bf16;
    ``q_start`` (B,) integer or None (0); returns (B, Sq, H, Dv) in q's
    dtype."""
    LAUNCHES["flash_attention_plain"] += 1
    f32 = torch.float32
    return _causal_online_softmax(
        q, lambda k0, k1: (k[:, k0:k1].to(f32), v[:, k0:k1].to(f32)),
        k.shape[1], v.shape[-1], scale, causal, q_start)


def flash_attention_quant_plain(q, k_quant, k_scales, v_quant, v_scales,
                                scale: float, kv_spec, causal: bool = True,
                                q_start=None) -> torch.Tensor:
    """Kernel #8's function in plain torch: the reference's
    ``_kernel_quant`` with ``_dequant_tile``, each key tile's codes and
    scale rows dequantized through ``kvquant.dequantize_kv`` (one f32
    multiply per element) right before the steps of
    :func:`flash_attention_plain`, which it therefore equals bitwise on the
    dequantized K/V.  q (B, Sq, H, D) f32 or bf16; k/v_quant (B, Skv, KH,
    D | D/2) int8 or packed uint8; k/v_scales (B, Skv, KH, D/group) f32.
    Returns (B, Sq, H, D) in q's dtype."""
    from repro_torch.serve.kvquant import dequantize_kv

    LAUNCHES["flash_attention_quant_plain"] += 1
    d = q.shape[-1]

    def tiles(k0, k1):
        return (dequantize_kv(k_quant[:, k0:k1], k_scales[:, k0:k1], kv_spec, d),
                dequantize_kv(v_quant[:, k0:k1], v_scales[:, k0:k1], kv_spec, d))

    return _causal_online_softmax(q, tiles, k_quant.shape[1], d, scale, causal,
                                  q_start)


def paged_flash_attention_plain(q, k_pages, v_pages, block_table, lengths,
                                scale: float) -> torch.Tensor:
    """Kernel #6's function in plain torch.  q (B, H, D) f32/bf16; k/v_pages
    (NP, P, KH, D|Dv) f32/bf16; block_table (B, MPB) and lengths (B,)
    integer.  Returns (B, H, Dv) in q's dtype."""
    LAUNCHES["paged_flash_attention_plain"] += 1
    f32 = torch.float32
    return _online_softmax(
        q, block_table, lengths, scale,
        lambda pids: (k_pages[pids].to(f32), v_pages[pids].to(f32)))


def paged_flash_attention_quant_plain(q, k_pages, k_scales, v_pages, v_scales,
                                      block_table, lengths, scale: float,
                                      kv_spec) -> torch.Tensor:
    """Kernel #9's function in plain torch: each gathered page dequantizes
    through ``kvquant.dequantize_kv``.  k/v_pages (NP, P, KH, D|D/2) int8 or
    packed uint8; k/v_scales (NP, P, KH, D/group) f32.  Returns (B, H, D)
    in q's dtype."""
    from repro_torch.serve.kvquant import dequantize_kv

    LAUNCHES["paged_flash_attention_quant_plain"] += 1
    d = q.shape[-1]
    return _online_softmax(
        q, block_table, lengths, scale,
        lambda pids: (dequantize_kv(k_pages[pids], k_scales[pids], kv_spec, d),
                      dequantize_kv(v_pages[pids], v_scales[pids], kv_spec, d)))


@functools.lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    """The built library with its C signature declared (once per name)."""
    lib = build.load(name)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "flash_attention":
        lib.flash_attention.argtypes = [p, i, p, p, i, p, p, i, i, i, i, i, i, i, f, i, p]
        lib.flash_attention.restype = ctypes.c_int
        lib.flash_attention_max_d.restype = ctypes.c_int
        lib.flash_attention_probe.argtypes = [p, p, p, p, p, i, p, p, p, p, p]
        lib.flash_attention_probe.restype = ctypes.c_int
    elif name == "flash_attention_quant":
        lib.flash_attention_quant.argtypes = [p, i, p, p, p, p, i, i, p, p,
                                              i, i, i, i, i, i, f, i, p]
        lib.flash_attention_quant.restype = ctypes.c_int
        lib.flash_attention_quant_max_d.restype = ctypes.c_int
    elif name == "paged_flash_attention":
        lib.paged_flash_attention.argtypes = [p, i, p, p, i, p, p, p, p,
                                              i, i, i, i, i, i, i, f, p]
        lib.paged_flash_attention.restype = ctypes.c_int
        lib.paged_flash_attention_pages_per_split.restype = ctypes.c_int
        lib.paged_flash_attention_warps.restype = ctypes.c_int
    else:
        lib.paged_flash_attention_quant.argtypes = [p, i, p, p, p, p, i, i, p, p, p, p,
                                                    i, i, i, i, i, i, f, p]
        lib.paged_flash_attention_quant.restype = ctypes.c_int
        lib.paged_flash_attention_quant_pages_per_split.restype = ctypes.c_int
        lib.paged_flash_attention_quant_warps.restype = ctypes.c_int
    return lib


def _check_common(q, k_pages, v_pages, block_table, lengths):
    """Shapes and types both kernels ask for; returns (B, H, KH, MPB)."""
    if q.dim() != 3 or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be (B, H, D) float32 or bfloat16; got "
                        f"{q.dtype} {tuple(q.shape)}")
    b, h, _ = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape[:3] + k_pages.shape[3:]:
        raise ValueError(f"k/v pages must be (NP, P, KH, ·) alike; got "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    kh = k_pages.shape[2]
    if kh == 0 or h % kh:
        raise ValueError(f"{h} query heads do not group over {kh} kv heads")
    if k_pages.shape[0] * k_pages.shape[1] * kh >= 2 ** 31:
        raise ValueError(f"a pool of {k_pages.shape[0]} pages of {k_pages.shape[1]} "
                         f"tokens x {kh} kv heads holds 2^31 rows or more")
    if block_table.dtype != torch.int32 or block_table.dim() != 2 \
            or block_table.shape[0] != b:
        raise ValueError(f"block_table must be int32 ({b}, MPB); got "
                         f"{block_table.dtype} {tuple(block_table.shape)}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths must be int32 ({b},); got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    return b, h, kh, block_table.shape[1]


def _workspace(q, mpb: int, dv: int):
    """The f32 partials (S, B, H, Dv + 2) of a call with S > 1 splits
    (:func:`paged_splits`), else None: allocated, never read here."""
    splits = paged_splits(mpb)
    if splits == 1:
        return None
    return torch.empty((splits, q.shape[0], q.shape[1], dv + 2), dtype=torch.float32,
                       device=q.device)


def paged_flash_attention(q, k_pages, v_pages, block_table, lengths,
                          scale: float) -> torch.Tensor:
    """One call of kernel #6; returns (B, H, Dv) in q's dtype.

    Arguments as :func:`paged_flash_attention_plain` (block_table and
    lengths int32 on the card).  A CPU ``q`` runs the plain version; a CUDA
    ``q`` launches the kernel on the current stream (with S > 1 splits, its
    combine after it), or raises."""
    if q.device.type == "cpu":
        return paged_flash_attention_plain(q, k_pages, v_pages, block_table,
                                           lengths, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, h, kh, mpb = _check_common(q, k_pages, v_pages, block_table, lengths)
    if k_pages.dtype not in (torch.float32, torch.bfloat16) \
            or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"pages must be float32 or bfloat16 alike; got "
                        f"{k_pages.dtype}, {v_pages.dtype}")
    if k_pages.shape[3] != q.shape[2]:
        raise ValueError(f"k rows are {k_pages.shape[3]} wide, q rows {q.shape[2]}")
    build.check_operands(q, [q, k_pages, v_pages, block_table, lengths])
    d, dv, page = q.shape[2], v_pages.shape[3], k_pages.shape[1]
    out = torch.empty((b, h, dv), dtype=q.dtype, device=q.device)
    part = _workspace(q, mpb, dv)
    rc = _lib("paged_flash_attention").paged_flash_attention(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k_pages.data_ptr(),
        v_pages.data_ptr(), int(k_pages.dtype == torch.bfloat16),
        block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        b, h, kh, d, dv, page, mpb, float(scale), build.stream_of(q))
    if rc != 0:
        raise RuntimeError(f"paged_flash_attention launch failed: cudaError {rc} "
                           f"at (B={b}, H={h}, KH={kh}, D={d}, P={page}, MPB={mpb})")
    LAUNCHES["paged_flash_attention"] += 1
    return out


def paged_flash_attention_quant(q, k_pages, k_scales, v_pages, v_scales,
                                block_table, lengths, scale: float,
                                kv_spec) -> torch.Tensor:
    """One call of kernel #9; returns (B, H, D) in q's dtype.

    Arguments as :func:`paged_flash_attention_quant_plain`.  A CPU ``q``
    runs the plain version; a CUDA ``q`` launches the kernel on the current
    stream (with S > 1 splits, its combine after it), or raises."""
    if q.device.type == "cpu":
        return paged_flash_attention_quant_plain(
            q, k_pages, k_scales, v_pages, v_scales, block_table, lengths,
            scale, kv_spec)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, h, kh, mpb = _check_common(q, k_pages, v_pages, block_table, lengths)
    d = q.shape[2]
    if not kv_spec.is_quantized:
        raise ValueError(f"kv spec {kv_spec.describe()!r} is not quantized")
    if k_pages.dtype != kv_spec.pool_dtype or v_pages.dtype != k_pages.dtype \
            or k_pages.shape[3] != kv_spec.packed_head_dim(d):
        raise TypeError(f"{kv_spec.describe()} pages must be {kv_spec.pool_dtype} "
                        f"(NP, P, KH, {kv_spec.packed_head_dim(d)}); got "
                        f"{k_pages.dtype} {tuple(k_pages.shape)}")
    group = kv_spec.group_for(d)
    want = k_pages.shape[:3] + (d // group,)
    for sc in (k_scales, v_scales):
        if sc.dtype != torch.float32 or sc.shape != want:
            raise ValueError(f"scales must be float32 {tuple(want)}; got "
                             f"{sc.dtype} {tuple(sc.shape)}")
    build.check_operands(q, [q, k_pages, k_scales, v_pages, v_scales,
                             block_table, lengths])
    page = k_pages.shape[1]
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    part = _workspace(q, mpb, d)
    rc = _lib("paged_flash_attention_quant").paged_flash_attention_quant(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k_pages.data_ptr(),
        k_scales.data_ptr(), v_pages.data_ptr(), v_scales.data_ptr(),
        int(kv_spec.dtype == "int4"), group, block_table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), None if part is None else part.data_ptr(),
        b, h, kh, d, page, mpb, float(scale), build.stream_of(q))
    if rc != 0:
        raise RuntimeError(f"paged_flash_attention_quant launch failed: cudaError "
                           f"{rc} at (B={b}, H={h}, KH={kh}, D={d}, P={page}, "
                           f"MPB={mpb}, {kv_spec.describe()})")
    LAUNCHES["paged_flash_attention_quant"] += 1
    return out


def _check_dense(q, kq, vq, q_start):
    """Shapes both dense kernels ask for; returns (B, Sq, H, D, Skv, KH)."""
    if q.dim() != 4 or kq.dim() != 4 or vq.dim() != 4:
        raise ValueError(f"q, k, v must be (B, S, heads, D); got {tuple(q.shape)}, "
                         f"{tuple(kq.shape)}, {tuple(vq.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    b, sq, h, d = q.shape
    skv, kh = kq.shape[1], kq.shape[2]
    if kq.shape[0] != b or vq.shape[:3] != kq.shape[:3]:
        raise ValueError(f"k and v must be ({b}, Skv, KH, ·) alike; got "
                         f"{tuple(kq.shape)}, {tuple(vq.shape)}")
    if kh == 0 or h % kh:
        raise ValueError(f"{h} query heads do not group over {kh} kv heads")
    if q_start is not None and (q_start.dtype != torch.int32
                                or tuple(q_start.shape) != (b,)):
        raise ValueError(f"q_start must be int32 ({b},); got {q_start.dtype} "
                         f"{tuple(q_start.shape)}")
    return b, sq, h, d, skv, kh


def flash_attention(q, k, v, scale: float, causal: bool = True,
                    q_start=None) -> torch.Tensor:
    """One launch of kernel #7; returns (B, Sq, H, Dv) in q's dtype.

    Arguments as :func:`flash_attention_plain`; on the card q is f32 or
    bf16, k and v share one dtype, f32 or bf16, every operand is
    contiguous, D, Dv <= ``MAX_D`` and ``q_start`` is None or (B,) int32.
    A CPU ``q`` runs the plain version; a CUDA ``q`` launches the kernel on
    the current stream, or raises."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, causal, q_start)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, sq, h, d, skv, kh = _check_dense(q, k, v, q_start)
    dv = v.shape[3]
    if k.dtype not in (torch.float32, torch.bfloat16) or v.dtype != k.dtype:
        raise TypeError(f"k and v must be float32 or bfloat16 alike; got "
                        f"{k.dtype}, {v.dtype}")
    if k.shape[3] != d:
        raise ValueError(f"k rows are {k.shape[3]} wide, q rows {d}")
    if max(d, dv) > MAX_D:
        raise ValueError(f"head dims {d}/{dv} exceed the kernel's {MAX_D}")
    build.check_operands(q, [t for t in (q, k, v, q_start) if t is not None])
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device)
    rc = _lib("flash_attention").flash_attention(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k.data_ptr(), v.data_ptr(),
        int(k.dtype == torch.bfloat16),
        None if q_start is None else q_start.data_ptr(), out.data_ptr(),
        b, sq, skv, h, kh, d, dv, float(scale), int(causal), build.stream_of(q))
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {rc} at "
                           f"(B={b}, Sq={sq}, Skv={skv}, H={h}, KH={kh}, D={d}, Dv={dv})")
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention_quant(q, k_quant, k_scales, v_quant, v_scales,
                          scale: float, kv_spec, causal: bool = True,
                          q_start=None) -> torch.Tensor:
    """One launch of kernel #8; returns (B, Sq, H, D) in q's dtype.

    Arguments as :func:`flash_attention_quant_plain`; on the card every
    operand is contiguous, D <= ``MAX_D`` and ``q_start`` is None or (B,)
    int32.  A CPU ``q`` runs the plain version; a CUDA ``q`` launches the
    kernel on the current stream, or raises."""
    if q.device.type == "cpu":
        return flash_attention_quant_plain(q, k_quant, k_scales, v_quant,
                                           v_scales, scale, kv_spec, causal,
                                           q_start)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, sq, h, d, skv, kh = _check_dense(q, k_quant, v_quant, q_start)
    if not kv_spec.is_quantized:
        raise ValueError(f"kv spec {kv_spec.describe()!r} is not quantized")
    if k_quant.dtype != kv_spec.pool_dtype or v_quant.dtype != k_quant.dtype \
            or k_quant.shape[3] != kv_spec.packed_head_dim(d):
        raise TypeError(f"{kv_spec.describe()} k/v must be {kv_spec.pool_dtype} "
                        f"(B, Skv, KH, {kv_spec.packed_head_dim(d)}); got "
                        f"{k_quant.dtype} {tuple(k_quant.shape)}")
    if d > MAX_D:
        raise ValueError(f"head dim {d} exceeds the kernel's {MAX_D}")
    group = kv_spec.group_for(d)
    want = k_quant.shape[:3] + (d // group,)
    for sc in (k_scales, v_scales):
        if sc.dtype != torch.float32 or sc.shape != want:
            raise ValueError(f"scales must be float32 {tuple(want)}; got "
                             f"{sc.dtype} {tuple(sc.shape)}")
    build.check_operands(q, [t for t in (q, k_quant, k_scales, v_quant, v_scales,
                                         q_start) if t is not None])
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    rc = _lib("flash_attention_quant").flash_attention_quant(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k_quant.data_ptr(),
        k_scales.data_ptr(), v_quant.data_ptr(), v_scales.data_ptr(),
        int(kv_spec.dtype == "int4"), group,
        None if q_start is None else q_start.data_ptr(), out.data_ptr(),
        b, sq, skv, h, kh, d, float(scale), int(causal), build.stream_of(q))
    if rc != 0:
        raise RuntimeError(f"flash_attention_quant launch failed: cudaError {rc} "
                           f"at (B={b}, Sq={sq}, Skv={skv}, H={h}, KH={kh}, D={d}, "
                           f"{kv_spec.describe()})")
    LAUNCHES["flash_attention_quant"] += 1
    return out


def tc_probe_plain(x, a, bt, c):
    """:func:`tc_probe`'s function in plain torch: :func:`tf32_split` of x
    (twice), and c + a·btᵀ summed exactly (float64, then rounded to f32)."""
    hi, lo = tf32_split(x)
    d = c.double() + a.double() @ bt.double().T
    return hi, lo, hi.clone(), lo.clone(), d.to(torch.float32)


def tc_probe(x, a, bt, c):
    """The dense kernels' TF32 split and one of their tensor-core products
    on chosen inputs (``flash_attention_probe``): returns the kernels' split
    (hi, lo) of x (n,) f32, the same split by ``cvt.rna.tf32.f32`` (hi_cvt,
    lo_cvt), and d (16, 8) = c (16, 8) + a (16, 8) · btᵀ (bt (8, 8)) from
    one m16n8k8 mma, a and bt holding TF32 values.  A CPU ``x`` runs the
    plain version; a CUDA ``x`` launches the probe, or raises."""
    if x.device.type == "cpu":
        return tc_probe_plain(x, a, bt, c)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    for t, shape in ((a, (16, 8)), (bt, (8, 8)), (c, (16, 8))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"probe operands must be float32 {shape}; got "
                             f"{t.dtype} {tuple(t.shape)}")
    if x.dtype != torch.float32 or x.dim() != 1:
        raise ValueError(f"x must be float32 (n,); got {x.dtype} {tuple(x.shape)}")
    build.check_operands(x, [x, a, bt, c])
    hi, lo, hi_cvt, lo_cvt = (torch.empty_like(x) for _ in range(4))
    d = torch.empty_like(c)
    rc = _lib("flash_attention").flash_attention_probe(
        x.data_ptr(), hi.data_ptr(), lo.data_ptr(), hi_cvt.data_ptr(), lo_cvt.data_ptr(),
        x.numel(), a.data_ptr(), bt.data_ptr(), c.data_ptr(), d.data_ptr(),
        build.stream_of(x))
    if rc != 0:
        raise RuntimeError(f"flash_attention_probe launch failed: cudaError {rc}")
    return hi, lo, hi_cvt, lo_cvt, d
